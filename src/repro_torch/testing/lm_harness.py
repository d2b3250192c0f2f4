"""The shared LM calibration fixture, the counterpart of
``repro/testing/lm_harness.py``: one definition of the params, the
calibration batch and the self-labels (the clean model's own argmax) that
differential tests and benchmarks build.  The port keeps it in
``repro_torch.lm_setup``; this name re-exports it."""
from repro_torch.lm_setup import lm_calibration_setup

__all__ = ["lm_calibration_setup"]
