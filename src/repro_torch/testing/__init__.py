"""Reference paths kept for benchmarking and bit-exactness tests, the
counterpart of ``repro/testing`` (its ``hypothesis_fallback`` is test
infrastructure that ``tests/conftest.py`` installs for both packages, no
part of the system, and has no counterpart here), and ``grad_room``, the
bound a test holds a fault-injected gradient to."""
