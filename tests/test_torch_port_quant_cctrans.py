"""CCTrans in int8 (dgvcc_tpu_torch/nn/quant_cctrans.py) against the JAX
package's graph (dgvcc_tpu/nn/quant_cctrans.py) on the CPU, in float32, at
tests/test_torch_port_baselines.py's tiny geometries: ``cctrans`` (64x64,
every strided site's input divisible by its stride) and ``cctrans_pad``
(80x80, ws 7: pe2 and pe3 pad their input high).

Under ``min_ch=128`` the strided int8 sites are pe3 and b2_1_sr; under
``min_ch=2`` every strided site is (pe0 with its Cin of 3 padded to 16
included), and the depthwise PEG, one input channel a group, stays fp.

Tolerances, as tests/test_torch_port_quant.py states them: the int8 site
list exact, calibration scales 1e-5 relative, the folded f32 graph 1e-4 of
the model's largest value, a strided int8 site bit for bit against the JAX
site run eagerly on the input the JAX graph gave it, the end-to-end int8
counts on the JAX scales at ``INT8_COUNT`` of the map's mass; an artifact
of either package served by the other: the port against its own graph on
the same sites bit for bit, the JAX package against its own at 1e-4 of the
largest value (XLA's jit rounds the quantize and the epilogue its own way).
"""

import copy
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgvcc_tpu.nn import quant as jq
from dgvcc_tpu.nn import quant_io as jqio
from dgvcc_tpu_torch.nn import quant as pq
from dgvcc_tpu_torch.nn import quant_io as pqio
from test_torch_port_baselines import CASES, _pair
from test_torch_port_quant import INT8_COUNT

MIN_CH = (128, 2)


def _strided(name):
    return name.startswith("pe") or name.endswith("_sr")


@pytest.fixture(scope="module")
def graphs():
    """case -> (port model, frames (2, H, W, 3) f32, {min_ch: JAX graph},
    JAX model, its variables): the JAX graphs built once."""
    out = {}
    for case in ("cctrans", "cctrans_pad"):
        jm, variables, pm = _pair(case)
        x = np.random.default_rng(3).normal(size=(2,) + CASES[case][2] + (3,)).astype(
            np.float32)
        out[case] = (pm, x, {m: jq.build_quantized(jm, variables, x, dtype=jnp.float32,
                                                   min_ch=m) for m in MIN_CH}, jm, variables)
    return out


def _int8(names):
    return sorted(n for n, s in names.items() if "w8" in s)


def _same_scales(pm, scales):
    fold, fwd, fp = pq._family_spec(pm)
    return pq.QuantizedConvNet.from_folded(fold(pm), scales, fwd, fp, torch.float32, "cpu")


def _run(q, x):
    with torch.inference_mode():
        return q(torch.from_numpy(x)).numpy()


@pytest.mark.parametrize("min_ch", MIN_CH)
@pytest.mark.parametrize("case", ["cctrans", "cctrans_pad"])
def test_int8_sites_and_scales_match_jax(graphs, case, min_ch):
    pm, x, jgs, _, _ = graphs[case]
    jg = jgs[min_ch]
    pg = pq.build_quantized(pm, x, dtype=torch.float32, device="cpu", min_ch=min_ch)
    want = _int8(jg.qparams["sites"])
    assert pg.int8_sites() == want
    assert pg.int8_min_batch == 8 == jg.int8_min_batch
    strided = [n for n in want if _strided(n)]
    if min_ch == 128:
        assert strided == (["b2_1_sr", "pe3"] if case == "cctrans" else ["pe3"])
    else:
        assert strided == sorted(n for n in pg.sites if _strided(n))
        assert not any(n.startswith("pos") for n in want)  # the depthwise PEG stays fp
    assert sorted(pg.scales) == sorted(jg.scales)
    for k, v in jg.scales.items():
        assert abs(pg.scales[k] - v) <= 1e-5 * v, k


@pytest.mark.parametrize("case", ["cctrans", "cctrans_pad"])
def test_folded_f32_graph_matches_the_model(graphs, case):
    """The port's model is held to the JAX model at 1e-4 in
    test_torch_port_baselines.py; its folded graph to it here."""
    pm, x, _, _, _ = graphs[case]
    fold, fwd, fp = pq._family_spec(pm)
    folded = fold(pm)
    assert "__extras__" in folded and "b0_0_norm1" in folded["__extras__"]
    got = _run(pq.QuantizedConvNet.from_folded(folded, {}, fwd, fp, torch.float32, "cpu"), x)
    with torch.inference_mode():
        want = pm.eval()(torch.from_numpy(x.transpose(0, 3, 1, 2))).numpy().transpose(0, 2, 3, 1)
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= 1e-4 * float(np.abs(want).max())


@pytest.mark.parametrize("min_ch", MIN_CH)
@pytest.mark.parametrize("case", ["cctrans", "cctrans_pad"])
def test_int8_counts_match_jax_on_its_scales(graphs, case, min_ch):
    pm, x, jgs, _, _ = graphs[case]
    jg = jgs[min_ch]
    want = np.asarray(jg(jnp.asarray(x)), np.float32)
    got = _run(_same_scales(pm, jg.scales), x)
    assert got.shape == want.shape
    mass = np.abs(want).sum(axis=(1, 2, 3))
    assert np.all(np.abs(got.sum(axis=(1, 2, 3)) - want.sum(axis=(1, 2, 3)))
                  <= INT8_COUNT * mass), (got.sum(axis=(1, 2, 3)), want.sum(axis=(1, 2, 3)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(__file__)), "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("case", ["cctrans", "cctrans_pad"])
def test_the_head_before_its_relu_matches_jax(graphs, case):
    """What chip_smoke.py phase 14 holds CCTrans's int8 map by on the card,
    and scripts/int8_drift.py measures in the JAX package: the head's last
    site, reg_res2, before its ReLU. The model's (the output of
    ``regression.res[3]``) at 1e-4 of its largest value; the int8 graph's on
    the JAX scales (``chip_smoke.without_last_relu``) at ``INT8_COUNT`` as
    |a - b| / |b| per frame (a quantize rounding flipped by float32
    differences moves it: 3.4e-2 at cctrans_pad under min_ch=2)."""
    cs = _chip_smoke()
    pm, x, jgs, jm, variables = graphs[case]
    _, st = jax.jit(lambda v, t: jm.apply(
        v, t, capture_intermediates=lambda m, _: m.name == "res2",
        mutable=["intermediates"]))(variables, jnp.asarray(x))
    want = np.asarray(st["intermediates"]["regression"]["res2"]["__call__"][0])
    seen = []
    hook = pm.eval().regression.res[3].register_forward_hook(
        lambda mod, args, out: seen.append(out))
    try:
        with torch.inference_mode():
            pm(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    finally:
        hook.remove()
    got = seen[0].permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= 1e-4 * float(np.abs(want).max())
    jg = copy.copy(jgs[128])
    jg.forward_fn = cs.without_last_relu(jg.forward_fn, "reg_res2")
    jg._jitted = jax.jit(jg._forward)
    want8 = np.asarray(jg(jnp.asarray(x)))
    same = _same_scales(pm, jg.scales)
    same.forward_fn = cs.without_last_relu(same.forward_fn, "reg_res2")
    got8 = _run(same, x)
    assert (want8 < 0).any()  # the ReLU is off
    assert np.all(cs.rel_l2(got8, want8) <= INT8_COUNT), cs.rel_l2(got8, want8)


def _jax_strided_io(jg, x):
    """{site: (input, relu, stride, output)} of each strided int8 site of
    the JAX graph: the inputs from one jitted run, each output from the JAX
    site alone on its input, eagerly (tests/test_torch_port_quant.py::
    _jax_site_io's method)."""
    keywords = {}
    orig = jg._qconv

    def run(frames):
        seen = {}

        def record(qp, t, name, **kw):
            if "w8" in qp["sites"][name] and _strided(name):
                seen[name] = t
                keywords[name] = kw
            return orig(qp, t, name, **kw)

        jg._qconv = record
        try:
            jg._forward(jg.qparams, frames)
        finally:
            jg._qconv = orig
        return seen

    seen = jax.device_get(jax.jit(run)(jnp.asarray(x)))
    return {name: (t, keywords[name].get("relu", True), keywords[name]["strides"][0],
                   np.asarray(orig(jg.qparams, t, name, **keywords[name])))
            for name, t in seen.items()}


@pytest.mark.parametrize("case", ["cctrans", "cctrans_pad"])
def test_every_strided_site_matches_the_jax_site_bit_for_bit(graphs, case):
    pm, x, jgs, _, _ = graphs[case]
    jg = jgs[2]
    same = _same_scales(pm, jg.scales)
    sites = _jax_strided_io(jg, x)
    assert sorted(sites) == sorted(n for n in same.int8_sites() if _strided(n))
    for name, (t, relu, stride, out) in sites.items():
        with torch.inference_mode():
            y = same._qconv(torch.tensor(t), name, relu=relu, stride=stride)
        assert y.shape == out.shape and np.array_equal(y.numpy(), out), name


def test_an_artifact_crosses_both_ways(graphs, tmp_path):
    pm, x, jgs, jm, variables = graphs["cctrans_pad"]
    jg = jgs[128]
    params = {k: list(v) for k, v in CASES["cctrans_pad"][1].items()}
    # the JAX package's artifact in the port: bit for bit against the port's
    # own graph on the same sites, with the family's floor (the JAX artifact
    # stores none)
    path = str(tmp_path / "jax.int8")
    jqio.save_quantized(jg, path, "cctrans", params)
    art = pqio.load_quantized(path, device="cpu")
    same = _same_scales(pm, jg.scales)
    assert art.quantized.int8_sites() == same.int8_sites()
    assert art.quantized.int8_min_batch == 8
    assert np.array_equal(_run(art.quantized, x), _run(same, x))
    # the port's artifact in the JAX package and back in the port
    q = pq.build_quantized(pm, x, dtype=torch.float32, device="cpu")
    path = str(tmp_path / "port.int8")
    pqio.save_quantized(q, path, "cctrans", params)
    back = pqio.load_quantized(path, device="cpu").quantized
    assert back.int8_min_batch == 8 and np.array_equal(_run(back, x), _run(q, x))
    theirs = jqio.load_quantized(path, dtype=jnp.float32).quantized
    fold, fwd, fp = jq._family_spec(jm)
    want = np.asarray(jq.QuantizedConvNet(fold(variables), q.scales, fwd, fp,
                                          dtype=jnp.float32)(jnp.asarray(x)))
    got = np.asarray(theirs(jnp.asarray(x)))
    assert float(np.abs(got - want).max()) <= 1e-4 * float(np.abs(want).max())


def _frames(n, seed=5, hw=(64, 64)):
    return np.random.default_rng(seed).integers(0, 256, (n,) + hw + (3,), dtype=np.uint8)


def test_auto_waits_for_the_cctrans_floor_before_calibrating():
    """quantize="auto" with an integer threshold below CCTrans's floor of 8:
    no fold or calibration until a dispatch reaches the floor."""
    from dgvcc_tpu_torch.core.registry import MODELS
    from dgvcc_tpu_torch.serve import VideoCounter

    pm = MODELS.build("cctrans", **CASES["cctrans"][1])
    c = VideoCounter(pm, dtype=torch.float32, device="cpu", quantize="auto", auto_threshold=2)
    assert c._family_min_batch() == 8
    c.count_frames(_frames(4))
    assert c.quantized is None and c.dispatches == {"fp": 1, "int8": 0}
    c.count_frames(_frames(8))
    assert c.quantized.int8_min_batch == 8 and c.dispatches == {"fp": 1, "int8": 1}


def test_cli_quantize_and_serve_a_cctrans_checkpoint(tmp_path, capsys):
    """``--task quantize`` then ``--task serve --artifact``, and ``--task
    serve --quantize``, on a CCTrans config (sta_cctrans.yml's model at the
    tiny geometry, seeded weights)."""
    import yaml
    from PIL import Image

    from dgvcc_tpu_torch.cli.main import main
    from dgvcc_tpu_torch.serve import VideoCounter

    frames = tmp_path / "frames"
    frames.mkdir()
    for i, img in enumerate(_frames(3, seed=4)):
        Image.fromarray(img).save(frames / f"img{i}.jpg")
    params = {k: list(v) for k, v in CASES["cctrans"][1].items()}
    counter = VideoCounter.from_checkpoint("cctrans", None, dtype=torch.float32, device="cpu",
                                           seed=3, **CASES["cctrans"][1])
    ckpt = tmp_path / "cctrans.pth"
    torch.save(counter.model.state_dict(), ckpt)
    cfg = tmp_path / "cfg.yml"
    cfg.write_text(yaml.safe_dump({
        "seed": 0, "version": "t", "device": "cpu", "log_para": 1000, "checkpoint": str(ckpt),
        "compute_dtype": "float32", "model": {"name": "cctrans", "params": params}}))
    art = str(tmp_path / "cctrans.int8")
    main(["--config", str(cfg), "--task", "quantize", "--frames", str(frames), "--out", art])
    assert "int8 sites" in capsys.readouterr().out
    assert pqio.load_quantized(art, device="cpu").quantized.int8_min_batch == 8
    for extra in (["--artifact", art], ["--quantize"]):
        main(["--config", str(cfg), "--task", "serve", "--frames", str(frames), *extra])
        lines = capsys.readouterr().out.strip().splitlines()
        assert lines[-1].startswith("[serve] 3 frames") and lines[-1].endswith("(int8)")
