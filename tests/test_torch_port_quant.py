"""The port's int8 PTQ graphs (dgvcc_tpu_torch/nn/quant.py, ops/qconv.py)
against the JAX package's (dgvcc_tpu/nn/quant.py) on the CPU, in float32.

Weights come from numpy seeds into the JAX variables and reach the port
through its bridges (nn/convert.py). `final` is the JAX test's geometry
(tests/test_quant.py: the full VGG16-BN U-Net, an 8 x 16 bank, 64x96
frames); the baselines run at full width on 32-64 px inputs, as
tests/test_torch_port_baselines.py runs them.

Tolerances:
  * the int8 convolution (the plain version, the only one on the CPU)
    against XLA's int8 x int8 -> int32 convolution, its epilogue, fold_bn,
    quantize_weight, the folded sites and an int8 site's output on the same
    input: bit for bit;
  * the folded f32 graphs: 1e-4 of the largest value (another order of
    summation), `final`'s against the JAX one, a baseline's against the
    port's model (held to the JAX model in test_torch_port_baselines.py);
    calibration scales: 1e-5 relative;
  * `final`'s int8 density on the same scales: 1e-4 of the map's mass, per
    frame, for the count and for the sum of |difference|.
The baselines' end-to-end int8 counts are not held at 1e-4: at these sizes
an untrained int8 graph moves its counts by up to two percent when its f32
inputs move by rounding (the JAX graph's own: sasnet 5.2e-3–2.0e-2 at
64x64, dssinet 2.8e-3–1.6e-2, csrnet 3.7e-3–1.1e-2, bl 2.6e-4–5.6e-4 at
32x48, under 1e-6 and 1e-5 relative input noise: scripts/int8_drift.py
FAMILY --sensitivity --hw H W --frames 2 --calib 2 --port-seed 11), because
an activation that lands on the other side of a rounding boundary or a ReLU
takes its neighbours with it. So a family's counts are held against the
JAX int8 graph's on the same scales at 3x the largest of these (INT8_COUNT,
6e-2 of the mass; read: csrnet 1.0e-7, mcnn 6.9e-8, sasnet 5.1e-4,
dssinet 3.9e-4, bl 3.0e-2, where bl's fp 64-channel convolutions sum in
another order, one activation of features/conv7 quantizes one step apart
and the difference spreads to 3,406 of features/conv25's), each int8 site of csrnet and bl (sasnet's and dssinet's
run the same primitive; skipped for time) bit for bit on the input the JAX
graph gave it, and every graph's wiring by its folded f32 graph.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgvcc_tpu.nn import quant as jq
from dgvcc_tpu_torch.nn import quant as pq
from dgvcc_tpu_torch.ops import qconv
from test_torch_port_baselines import CASES, _pair, _variable_shapes
from test_torch_port_helpers import randomize

FINAL = dict(mem_size=8, mem_dim=16)
MASS = 1e-4
# a family's end-to-end int8 count against the JAX graph's on the same
# scales, as a share of the map's mass: 3x the largest move of the JAX
# int8 graph's own counts under rounding-size input noise (sasnet 2.0e-2
# at 64x64; see the module docstring)
INT8_COUNT = 6e-2


@pytest.fixture(scope="module")
def final():
    """(jax model, variables, port model, frames (2, 64, 96, 3) f32, the JAX
    folded sites, the JAX calibration caps)."""
    from dgvcc_tpu.core.registry import MODELS as JAX_MODELS
    from dgvcc_tpu_torch.core.registry import MODELS
    from dgvcc_tpu_torch.nn.convert import dg_state_dict_from_flax

    jm = JAX_MODELS.build("final", **FINAL)
    rng = np.random.default_rng(7)
    params, stats = (randomize(tree, rng) for tree in _variable_shapes(jm, (64, 96)))
    variables = {"params": params, "batch_stats": stats}
    pm = MODELS.build("final", fused_mem=False, **FINAL)
    pm.load_state_dict(dg_state_dict_from_flax(params, stats), strict=True)
    pm.eval()
    x = rng.normal(size=(2, 64, 96, 3)).astype(np.float32)
    folded = jq.fold_variables(variables, jm)
    mem = np.asarray(variables["params"]["memory"]["mem"])
    return jm, variables, pm, x, folded, jq.calibrate(jm, folded, mem, x)


# ---- the int8 convolution ------------------------------------------------------

# (cin, k, dilation, stride, H, W): the stride-1 cases at 13x11, then CCTrans's
# strided windows (k x k at stride k, 2 / 4 / 8) on sizes the stride divides
# and does not (SAME pads them low and high), and a 3x3 window at stride 2
PLAIN_CASES = [(cin, k, dil, 1, 13, 11) for cin in (3, 64, 67) for k in (1, 3) for dil in (1, 2)]
PLAIN_CASES += [(cin, k, 1, k, h, w) for cin, k, h, w in (
    (64, 2, 12, 10), (3, 2, 13, 11), (67, 4, 16, 8), (16, 4, 13, 11), (64, 8, 16, 24),
    (16, 8, 13, 21), (67, 8, 5, 3))] + [(16, 3, 1, 2, 13, 11)]


@pytest.mark.parametrize("cin,k,dil,stride,h,w", PLAIN_CASES, ids=[
    f"{c[0]}-{c[1]}-{c[2]}" if c[3] == 1 else "{}-{}-{}-s{}-{}x{}".format(*c)
    for c in PLAIN_CASES])
def test_plain_int8_conv_matches_xla_bit_for_bit(cin, k, dil, stride, h, w):
    rng = np.random.default_rng(cin * 10 + k + dil + (stride > 1) * (100 * stride + h))
    xq = rng.integers(-127, 128, (2, h, w, cin), dtype=np.int8)
    w8 = rng.integers(-127, 128, (k, k, cin, 5), dtype=np.int8)  # HWIO
    ws = (rng.random(5) * 1e-3).astype(np.float32)
    bias = rng.normal(size=5).astype(np.float32)
    s = 0.0371
    want = jax.lax.conv_general_dilated(
        jnp.asarray(xq), jnp.asarray(w8), (stride, stride), "SAME", rhs_dilation=(dil, dil),
        dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32)
    y_want = jax.nn.relu(want.astype(jnp.float32) * (jnp.asarray(ws) * s) + jnp.asarray(bias))
    w8_port = torch.from_numpy(np.ascontiguousarray(w8.transpose(3, 0, 1, 2)))
    acc = qconv.qconv_int8(torch.from_numpy(xq), w8_port, None, s, None, dilation=dil, acc=True,
                           stride=stride)
    assert acc.dtype == torch.int32 and np.array_equal(acc.numpy(), np.asarray(want))
    y = qconv.qconv_int8(torch.from_numpy(xq), w8_port, torch.from_numpy(ws), s,
                         torch.from_numpy(bias), dilation=dil, out_dtype=torch.float32,
                         stride=stride)
    assert np.array_equal(y.numpy(), np.asarray(y_want))
    x = rng.normal(size=(2, 5, 7, 3)).astype(np.float32) * 4
    want_q = jnp.clip(jnp.round(jnp.asarray(x) / s), -127, 127).astype(jnp.int8)
    assert np.array_equal(qconv.quantize_activation(torch.from_numpy(x), s).numpy(),
                          np.asarray(want_q))


@pytest.mark.parametrize("k,dil,stride", [(1, 1, 9), (1, 1, 0), (2, 1, 4), (2, 1, 1),
                                          (3, 0, 1)])
def test_plain_int8_conv_refuses_what_the_kernel_refuses(k, dil, stride):
    """On the CPU the entry point refuses what it refuses on the card: a
    stride outside 1..8 (TMA's element strides), an even window at another
    stride than its own, a dilation below 1."""
    xq = torch.zeros(1, 16, 16, 16, dtype=torch.int8)
    w8 = torch.zeros(8, k, k, 16, dtype=torch.int8)
    with pytest.raises(ValueError, match="stride"):
        qconv.qconv_int8(xq, w8, torch.ones(8), 0.1, torch.zeros(8), dilation=dil,
                         stride=stride)


def test_fold_bn_and_quantize_weight_match_bit_for_bit():
    rng = np.random.default_rng(0)
    k = rng.normal(size=(3, 3, 4, 6)).astype(np.float32)
    args = [rng.normal(size=6).astype(np.float32), rng.uniform(0.5, 1.5, 6).astype(np.float32),
            rng.normal(size=6).astype(np.float32), rng.normal(size=6).astype(np.float32),
            rng.uniform(0.5, 2.0, 6).astype(np.float32)]
    for bias in (args[0], None):
        for eps in (1e-5, 1e-3):
            got, want = pq.fold_bn(k, bias, *args[1:], eps=eps), jq.fold_bn(k, bias, *args[1:],
                                                                            eps=eps)
            assert all(np.array_equal(a, b) for a, b in zip(got, want))
    k = k * rng.uniform(0.1, 10.0, 6).astype(np.float32)
    k[..., 2] = 0  # a dead channel: the scale floor
    assert all(np.array_equal(a, b) for a, b in zip(pq.quantize_weight(k), jq.quantize_weight(k)))


# ---- the DG family -------------------------------------------------------------

def test_folded_sites_and_f32_graph_match_jax(final):
    jm, variables, pm, x, folded, _ = final
    port = pq.fold_variables(pm)
    assert sorted(port) == sorted(folded)
    for name, site in folded.items():
        assert np.array_equal(port[name]["kernel"], site["kernel"]), name
        assert np.array_equal(port[name]["bias"], site["bias"]), name
    want = jq.fp_folded_forward(jm, variables, x)
    got = pq.fp_folded_forward(pm, x, device="cpu")
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        assert float(np.abs(g.numpy() - w).max()) <= 1e-4 * float(np.abs(w).max())


def test_calibration_scales_match_jax(final):
    _, _, pm, x, _, caps = final
    got = pq.calibrate(pm, pq.fold_variables(pm), pq._bank(pm), x, device="cpu")
    assert sorted(got) == sorted(caps) and len(caps) == 21
    for k, v in caps.items():
        assert abs(got[k] - v) <= 1e-5 * v, k


@pytest.mark.parametrize("weight_only", [False, True])
def test_quantized_dg_matches_jax_on_the_same_scales(final, weight_only):
    """21 int8 sites: the 13 encoder convolutions, the 6 decoder ones,
    den_dec and cls_conv1 (den_head and cls_conv2 stay fp)."""
    jm, variables, pm, x, folded, caps = final
    scales = {} if weight_only else {k: max(v, 1e-12) / 127.0 for k, v in caps.items()}
    mem = np.asarray(variables["params"]["memory"]["mem"])
    jg = jq.QuantizedDG(folded, scales, jm, mem, dtype=jnp.float32, fused_mem=False,
                        weight_only=weight_only)
    want_d, want_c = (np.asarray(t) for t in jg(jnp.asarray(x)))
    pg = pq.QuantizedDG.from_folded(pq.fold_variables(pm), scales, pm, pq._bank(pm),
                                    torch.float32, "cpu", weight_only=weight_only)
    with torch.inference_mode():
        got_d, got_c = (t.numpy() for t in pg(torch.from_numpy(x)))
    w8 = sorted(n for n, s in jg.qparams["sites"].items() if "w8" in s)
    assert sorted(n for n, s in pg.sites.items() if "w8" in s) == w8 and len(w8) == 21
    assert "den_head" not in w8 and "cls_conv2" not in w8
    assert pg.int8_sites() == ([] if weight_only else w8)
    mass = np.abs(want_d).sum(axis=(1, 2, 3))
    assert np.all(np.abs(got_d.sum(axis=(1, 2, 3)) - want_d.sum(axis=(1, 2, 3))) <= MASS * mass)
    assert np.all(np.abs(got_d - want_d).sum(axis=(1, 2, 3)) <= MASS * mass)
    assert float(np.abs(got_c - want_c).max()) <= 1e-4


def test_build_quantized_refuses_what_it_cannot_fold():
    from dgvcc_tpu_torch.core.registry import MODELS

    with pytest.raises(ValueError, match="instance"):
        pq.build_quantized(MODELS.build("sw"), np.zeros((1, 32, 32, 3), np.float32))
    # CCTrans is taken now (tests/test_torch_port_quant_cctrans.py holds its graph)
    pq.check_quantizable(MODELS.build("cctrans", **CASES["cctrans"][1]))


# ---- the conv families -----------------------------------------------------------

def _jax_site_io(jg, x):
    """(the graph's density, {site: (input or its concat parts, relu,
    dilation, output)} of each int8 site of the JAX graph): the density and
    the inputs from one jitted run, each output from the JAX site alone on
    that input, eagerly (under jit XLA rounds the quantize and the epilogue
    its own way; eager, each op rounds once)."""
    keywords = {}
    orig = jg._qconv

    def run(frames):
        seen = {}

        def record(qp, t, name, relu=True, padding="SAME", dilation=(1, 1), **kw):
            if "w8" in qp["sites"][name]:
                seen[name] = list(t) if isinstance(t, (list, tuple)) else t
                keywords[name] = dict(relu=relu, padding=padding, dilation=dilation, **kw)
            return orig(qp, t, name, relu=relu, padding=padding, dilation=dilation, **kw)

        jg._qconv = record
        try:
            out = jg._forward(jg.qparams, frames)
        finally:
            jg._qconv = orig
        return out, seen

    out, seen = jax.device_get(jax.jit(run)(jnp.asarray(x)))
    return np.asarray(out, np.float32), {
        name: (t, keywords[name]["relu"], keywords[name]["dilation"][0],
               np.asarray(orig(jg.qparams, t, name, **keywords[name])))
        for name, t in seen.items()}


@pytest.mark.parametrize("case", ["csrnet", "mcnn", "bl", "sasnet", "dssinet"])
def test_build_quantized_families_match_jax(case):
    """The same int8 sites under min_ch=128 (mcnn: none), calibration scales
    at 1e-5, the folded f32 graph at 1e-4 of the model's forward, the int8
    counts at INT8_COUNT of the JAX graph's on the JAX scales, and (csrnet,
    bl) every int8 site bit for bit on the JAX graph's input with them."""
    jm, variables, pm = _pair(case)
    x = np.random.default_rng(3).normal(size=(1,) + CASES[case][2] + (3,)).astype(np.float32)
    jg = jq.build_quantized(jm, variables, x, dtype=jnp.float32)
    pg = pq.build_quantized(pm, x, dtype=torch.float32, device="cpu")
    want_sites = sorted(n for n, s in jg.qparams["sites"].items() if "w8" in s)
    assert pg.int8_sites() == want_sites
    assert (len(want_sites) == 0) == (case == "mcnn")
    for k, v in jg.scales.items():
        assert abs(pg.scales[k] - v) <= 1e-5 * v, k

    # the folded f32 graph against the port's model, which
    # test_torch_port_baselines.py holds to the JAX model at 1e-4
    fold, fwd, fp = pq._family_spec(pm)
    with torch.inference_mode():
        got = pq.QuantizedConvNet.from_folded(fold(pm), {}, fwd, fp, torch.float32, "cpu")(
            torch.from_numpy(x)).numpy()
        want = pm.eval()(torch.from_numpy(x.transpose(0, 3, 1, 2))).numpy().transpose(0, 2, 3, 1)
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= 1e-4 * float(np.abs(want).max())

    # end to end on the JAX scales: the counts of the port's int8 graph
    # against the JAX one's, at INT8_COUNT of the map's mass. sasnet's and
    # dssinet's 29 and 46 int8 sites run the site primitive that csrnet's
    # and bl's hold bit for bit below, and `final`'s concat sites hold at
    # 1e-4 of the mass (an eager JAX site run costs a second or more a site)
    same = pq.QuantizedConvNet.from_folded(fold(pm), jg.scales, fwd, fp, torch.float32,
                                           "cpu")
    want, sites = (_jax_site_io(jg, x) if case in ("csrnet", "bl")
                   else (np.asarray(jg(jnp.asarray(x)), np.float32), {}))
    with torch.inference_mode():
        got = same(torch.from_numpy(x)).numpy()
    mass = np.abs(want).sum(axis=(1, 2, 3))
    assert np.all(np.abs(got.sum(axis=(1, 2, 3)) - want.sum(axis=(1, 2, 3)))
                  <= INT8_COUNT * mass), case

    for name, (t, relu, dil, out) in sites.items():
        t = [torch.tensor(p) for p in t] if isinstance(t, list) else torch.tensor(t)
        with torch.inference_mode():
            y = same._qconv(t, name, relu=relu, dilation=dil)
        assert np.array_equal(y.numpy(), out), name
