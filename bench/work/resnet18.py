"""The work one calibration pass of each ResNet18 unit needs, from the
configuration's shapes: ``n_eval`` images through the unit.

  * ``conv_flops``: 2 x the convolutions' MACs (3x3 and 1x1 at the unit's
    output resolution) x images; ``flops`` adds the dense head's;
  * ``act_elems`` / ``act_bytes``: the unit's input activations, which
    ``quant_bitflip`` reads once and writes once (float32);
  * ``act_draws``: the hash draws of that input's fault mask, one a
    faulty bit an element.  A draw depends on index, seed and plane alone,
    so an environment needs them once a unit, whatever the rows.
"""
from __future__ import annotations

# the group the profile files the kernels it does not know under
LIBRARY_GROUP = "cudnn_conv"


def unit_work(conf) -> list[dict]:
    chs, nc, hw, n = (conf["stage_channels"], conf["num_classes"],
                      conf["img"], conf["n_eval"])
    fb = conf["fault"]["faulty_bits"]
    out = []
    macs = 9 * 3 * chs[0] * hw * hw
    inp = hw * hw * 3
    out.append((macs, 0, inp))
    cin = chs[0]
    for stage, cout in enumerate(chs):
        for blk in range(2):
            stride = 2 if (stage > 0 and blk == 0) else 1
            o = hw // stride
            macs = 9 * cin * cout * o * o + 9 * cout * cout * o * o
            if stride != 1 or cin != cout:
                macs += cin * cout * o * o
            out.append((macs, 0, hw * hw * cin))
            hw, cin = o, cout
    out.append((0, chs[3] * nc, chs[3]))
    return [{"conv_flops": 2.0 * conv * n, "flops": 2.0 * (conv + dense) * n,
             "act_elems": elems * n, "act_bytes": 2 * 4 * elems * n,
             "act_draws": elems * n * fb, "fm_flops": 0.0, "fm_bytes": 0.0,
             "fm_draws": 0}
            for conv, dense, elems in out]
