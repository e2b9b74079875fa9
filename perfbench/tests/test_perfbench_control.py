"""The control on the card: the reference in TF32 (the nearest precision
below the configurations' f32 with TF32 off) in the program's place comes
out as not correct under the cells' own limits, here at a small size
(the tiny configurations, on the card); at the cells' own sizes the same
readings come from `python -m perfbench.core.calibrate --control`
(each driver's `control`)."""

import pytest

from perfbench.core import cell, spec as specs

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("name", ["c2f_r50.burnin", "swinl.serve_sat",
                                  "c2f_r50.serve_open"])
def test_tf32_control_fails(cuda, tiny, name):
    spec = cell.load(name)
    for k in ("config", "traffic"):
        spec[k] = dict(spec[k], **spec[k]["tiny"])
    fn = specs.driver(spec["cell"]["driver"]).control
    failed = 0
    for seed in (2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3):
        checks = fn(spec, seed, cuda)
        failed += any(checks[k] > v
                      for k, v in spec["cell"]["limits"].items())
    assert failed == 3
