"""One int8 site each of sasnet and dssinet, bit for bit against the JAX
package's site, as tests/test_torch_port_quant.py holds csrnet's and bl's.

The port's int8 graph runs on the JAX graph's calibration scales; the site's
input (a tensor, or the parts of a channel concatenation) is recorded in the
port's forward, and the same input goes through the JAX site alone, eagerly
(under jit XLA rounds the quantize and the epilogue its own way; eager, each
op rounds once, as the port does). The sites take shapes that `final` has
not: sasnet's 5x5 window, dssinet's 1x1 decoder site on the concatenation
of two parts (768 channels). On the CPU the site runs the int8
convolution's plain version (ops/qconv.py); chip_smoke.py phase 14 holds the
kernel against it at sites of these two families on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgvcc_tpu.nn import quant as jq
from dgvcc_tpu_torch.nn import quant as pq
from test_torch_port_baselines import CASES, _pair

SITES = {"sasnet": "MultiBranch_0/BasicConv_5", "dssinet": "decoder2/c1"}


@pytest.mark.parametrize("case", sorted(SITES))
def test_int8_site_matches_the_jax_site_bit_for_bit(case):
    name = SITES[case]
    jm, variables, pm = _pair(case)
    x = np.random.default_rng(3).normal(size=(1,) + CASES[case][2] + (3,)).astype(np.float32)
    jg = jq.build_quantized(jm, variables, x, dtype=jnp.float32)
    assert "w8" in jg.qparams["sites"][name]
    fold, fwd, fp = pq._family_spec(pm)
    graph = pq.QuantizedConvNet.from_folded(fold(pm), jg.scales, fwd, fp, torch.float32, "cpu")
    assert name in graph.int8_sites()

    seen, orig = {}, graph._qconv

    def record(t, site, relu=True, dilation=1):
        y = orig(t, site, relu=relu, dilation=dilation)
        if site == name:
            parts = list(t) if isinstance(t, (list, tuple)) else t
            seen.update(t=parts, relu=relu, dilation=dilation, y=y)
        return y

    graph._qconv = record
    with torch.inference_mode():
        graph(torch.from_numpy(x))
    assert seen, f"{name} was not called"

    t = seen["t"]
    jt = [jnp.asarray(p.numpy()) for p in t] if isinstance(t, list) else jnp.asarray(t.numpy())
    want = np.asarray(jg._qconv(jg.qparams, jt, name, relu=seen["relu"], padding="SAME",
                                dilation=(seen["dilation"],) * 2))
    got = seen["y"].numpy()
    w8 = jg.qparams["sites"][name]["w8"]
    if case == "sasnet":
        assert w8.shape[:2] == (5, 5)
    else:
        assert isinstance(t, list) and len(t) == 2 and w8.shape[2] == 768
    assert got.shape == want.shape and np.array_equal(got, want), name
