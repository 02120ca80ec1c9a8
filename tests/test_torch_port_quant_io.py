"""Int8 artifacts (dgvcc_tpu_torch/nn/quant_io.py) both ways between the
packages, int8 serving (serve.py: quantize=True / "auto", from_artifact) and
the command line's ``--task quantize`` / ``--artifact``, on the CPU in
float32, at the tiny `final` geometry (dgvcc_tpu/testing.py) and with a
full-width dssinet (PReLU slopes in the artifact's ``extras``) on 32x48.

Tolerances: a JAX artifact served by the port against the port's own graph
on the same sites: bit for bit; a port artifact served by the JAX package
against the JAX graph on the same sites: 1e-4 of the largest value (XLA's
jit rounds the quantize and the epilogue its own way); VideoCounter counts
against the JAX VideoCounter: 1e-4 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from dgvcc_tpu.nn import quant as jq
from dgvcc_tpu.nn import quant_io as jqio
from dgvcc_tpu.serve import VideoCounter as JaxCounter
from dgvcc_tpu.testing import TINY_MEM
from dgvcc_tpu_torch.cli.main import main
from dgvcc_tpu_torch.nn import quant as pq
from dgvcc_tpu_torch.nn import quant_io as pqio
from dgvcc_tpu_torch.serve import VideoCounter
from test_torch_port_baselines import _pair
from test_torch_port_helpers import dg_pair

GEOMETRY = {k: list(v) if isinstance(v, tuple) else v for k, v in TINY_MEM.items()}
GEOMETRY["dec_widths"] = [list(w) for w in TINY_MEM["dec_widths"]]
TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(scope="module")
def tiny():
    """(jax model, variables, port model, calibration frames (2, 64, 64, 3)
    f32, test frames (2, 64, 96, 3) f32)."""
    jm, variables, pm = dg_pair("final", seed=11)
    rng = np.random.default_rng(11)
    return (jm, variables, pm, rng.normal(size=(2, 64, 64, 3)).astype(np.float32),
            rng.normal(size=(2, 64, 96, 3)).astype(np.float32))


def _port_out(q, x):
    with torch.inference_mode():
        out = q(torch.from_numpy(x))
    return (out[0] if isinstance(out, tuple) else out).numpy()


@pytest.mark.parametrize("family", ["dg", "dssinet"])
def test_a_jax_artifact_serves_in_the_port_bit_for_bit(tiny, family, tmp_path):
    path = str(tmp_path / "jax.int8")
    if family == "dg":
        jm, variables, pm, calib, x = tiny
        jg = jq.QuantizedDG.from_model(jm, variables, calib, dtype=jnp.float32,
                                       fused_mem=False)
        jqio.save_quantized(jg, path, "final", GEOMETRY)
        same = pq.QuantizedDG.from_folded(pq.fold_variables(pm), jg.scales, pm, pq._bank(pm),
                                          torch.float32, "cpu")
    else:
        jm, variables, pm = _pair("dssinet")
        x = np.random.default_rng(2).normal(size=(1, 32, 48, 3)).astype(np.float32)
        jg = jq.build_quantized(jm, variables, x, dtype=jnp.float32)
        jqio.save_quantized(jg, path, "dssinet")
        fold, fwd, fp = pq._family_spec(pm)
        same = pq.QuantizedConvNet.from_folded(fold(pm), jg.scales, fwd, fp, torch.float32,
                                               "cpu")
    art = pqio.load_quantized(path, device="cpu")
    assert art.quantized.dtype == torch.float32 and not art.quantized.weight_only
    assert art.quantized.int8_min_batch == 1  # a JAX artifact stores no floor
    assert art.quantized.int8_sites() == same.int8_sites() and same.int8_sites()
    for name, site in same.sites.items():
        for k, v in site.items():
            assert np.array_equal(np.asarray(art.quantized.sites[name][k]), v), (name, k)
    assert np.array_equal(_port_out(art.quantized, x), _port_out(same, x))


def test_a_port_artifact_serves_in_jax(tiny, tmp_path):
    jm, variables, pm, calib, x = tiny
    q = pq.QuantizedDG.from_model(pm, calib, torch.float32, "cpu")
    path = str(tmp_path / "port.int8")
    pqio.save_quantized(q, path, "final", GEOMETRY)
    art = jqio.load_quantized(path, dtype=jnp.float32, fused_mem=False)
    folded = jq.fold_variables(variables, jm)
    mem = np.asarray(variables["params"]["memory"]["mem"])
    want = np.asarray(jq.QuantizedDG(folded, q.scales, jm, mem, dtype=jnp.float32,
                                     fused_mem=False)(jnp.asarray(x))[0])
    got = np.asarray(art.quantized(jnp.asarray(x))[0])
    assert float(np.abs(got - want).max()) <= 1e-4 * float(np.abs(want).max())
    np.testing.assert_allclose(_port_out(q, x), want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_weight_only_and_the_batch_floor_survive_a_round_trip(tiny, tmp_path):
    """The JAX artifact loses both (ROADMAP.md Queue 3): a weight-only graph
    reloads as full int8 with no scales, and the floor is not stored."""
    _, _, pm, _, x = tiny
    q = pq.QuantizedDG.from_model(pm, None, torch.float32, "cpu", weight_only=True)
    q.int8_min_batch = 8
    path = str(tmp_path / "wo.int8")
    pqio.save_quantized(q, path, "final", GEOMETRY)
    art = pqio.load_quantized(path, device="cpu")
    assert art.quantized.weight_only and art.quantized.int8_min_batch == 8
    assert art.quantized.int8_sites() == [] and len(art.quantized.sites) == len(q.sites)
    assert np.array_equal(_port_out(art.quantized, x), _port_out(q, x))


@pytest.mark.parametrize("entry", ["build_quantized", "from_model", "calibrate",
                                   "fp_folded_forward", "load_quantized"])
def test_the_int8_entry_points_run_on_cuda_unless_asked(tiny, entry, tmp_path):
    """Without ``device=``, each builds on cuda: here, with no card, it
    raises rather than falling back to the CPU."""
    _, _, pm, calib, x = tiny
    path = str(tmp_path / "wo.int8")
    pqio.save_quantized(pq.QuantizedDG.from_model(pm, None, torch.float32, "cpu",
                                                  weight_only=True), path, "final", GEOMETRY)
    call = {"build_quantized": lambda: pq.build_quantized(pm, calib, torch.float32),
            "from_model": lambda: pq.QuantizedDG.from_model(pm, calib, torch.float32),
            "calibrate": lambda: pq.calibrate(pm, pq.fold_variables(pm), pq._bank(pm), calib),
            "fp_folded_forward": lambda: pq.fp_folded_forward(pm, x),
            "load_quantized": lambda: pqio.load_quantized(path).quantized}[entry]
    if torch.cuda.is_available():
        out = call()
        if isinstance(out, tuple):  # fp_folded_forward's (density, cls)
            assert out[0].is_cuda
        elif not isinstance(out, dict):  # a graph (calibrate: its absmax floats)
            assert out.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()


def _frames(n, seed=5, hw=(100, 130)):
    return np.random.default_rng(seed).integers(0, 256, (n,) + hw + (3,), dtype=np.uint8)


def test_auto_calibrates_lazily_and_counts_dispatches(tiny):
    _, _, pm, _, _ = tiny
    c = VideoCounter(pm, dtype=torch.float32, device="cpu", quantize="auto", auto_threshold=2)
    assert c.quantized is None and c._quant_pending
    c.count_frames(_frames(1))
    assert c.quantized is None and c.dispatches == {"fp": 1, "int8": 0}
    c.count_frames(_frames(2))  # the first int8 dispatch calibrates
    assert c.quantized is not None and c.dispatches == {"fp": 1, "int8": 1}
    list(c.stream(iter([_frames(1), _frames(3)])))
    assert c.dispatches == {"fp": 2, "int8": 2}
    with pytest.raises(ValueError, match="artifact"):
        VideoCounter(pm, device="cpu", quantize="auto", quantized=c.quantized)


def test_an_integer_auto_threshold_keeps_the_graphs_floor(tiny):
    """The JAX counter lets auto_threshold go below the graph's
    int8_min_batch (ROADMAP.md Queue 3); the port keeps the floor."""
    _, _, pm, calib, _ = tiny
    q = pq.QuantizedDG.from_model(pm, calib, torch.float32, "cpu")
    q.int8_min_batch = 4
    c = VideoCounter(pm, dtype=torch.float32, device="cpu", quantize="auto", auto_threshold=1)
    c.quantized, c._quant_pending = q, False
    for b, want in ((1, False), (2, False), (3, False), (4, True), (8, True)):
        assert c._prefers_int8(_frames(b, hw=(64, 64))) is want, b
    c.count_frames(_frames(2))
    assert c.dispatches == {"fp": 1, "int8": 0}


@pytest.mark.parametrize("case", ["padded", "tiled"])
def test_int8_counter_and_its_artifact_match_the_jax_counter(tiny, case, tmp_path):
    jm, variables, pm, _, _ = tiny
    kw = dict(tile_size=64, tile_threshold=96) if case == "tiled" else {}
    calib = _frames(2, seed=9)
    jc = JaxCounter(jm, variables, dtype=jnp.float32, quantize=True, calib_frames=calib, **kw)
    pc = VideoCounter(pm, dtype=torch.float32, device="cpu", quantize=True,
                      calib_frames=calib, **kw)
    frames = [_frames(2, seed=s) for s in (5, 6)]
    want = [np.asarray(jc.count_frames(f)) for f in frames]
    got = [pc.count_frames(f) for f in frames]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)
    assert pc.dispatches == {"fp": 0, "int8": 2}
    path = str(tmp_path / "c.int8")
    pqio.save_quantized(pc.quantized, path, "final", GEOMETRY)
    ac = VideoCounter.from_artifact(path, device="cpu", **kw)
    assert ac.model is None  # an artifact's counter holds no fp weights
    for g, f in zip(got, frames):
        assert np.array_equal(ac.count_frames(f), g)
    streamed = list(ac.stream(iter(frames), prefetch=1))
    assert all(np.array_equal(s, g) for s, g in zip(streamed, got))


def test_cli_quantize_then_serve_the_artifact(tmp_path, capsys):
    frames = tmp_path / "frames"
    frames.mkdir()
    rng = np.random.default_rng(4)
    for i in range(3):
        Image.fromarray(rng.integers(0, 256, (70, 90, 3), dtype=np.uint8)).save(
            frames / f"img{i}.jpg")
    counter = VideoCounter.from_checkpoint("final", None, dtype=torch.float32, device="cpu",
                                           seed=3, **TINY_MEM)
    ckpt = tmp_path / "final.pth"
    torch.save(counter.model.state_dict(), ckpt)
    cfg, bare = tmp_path / "cfg.yml", tmp_path / "bare.yml"
    for path, ck in ((cfg, str(ckpt)), (bare, None)):
        path.write_text(yaml.safe_dump({
            "seed": 0, "version": "t", "device": "cpu", "log_para": 1000, "checkpoint": ck,
            "compute_dtype": "float32", "model": {"name": "final", "params": GEOMETRY}}))
    art = str(tmp_path / "final.int8")
    main(["--config", str(cfg), "--task", "quantize", "--frames", str(frames), "--out", art])
    assert "int8 sites" in capsys.readouterr().out
    main(["--config", str(cfg), "--task", "serve", "--frames", str(frames), "--artifact", art])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1].startswith("[serve] 3 frames") and lines[-1].endswith("(int8)")
    counts = np.array([float(ln.split()[1]) for ln in lines[:-1]])
    imgs = np.stack([np.asarray(Image.open(frames / f"img{i}.jpg").convert("RGB"))
                     for i in range(3)])
    np.testing.assert_allclose(counts, VideoCounter.from_artifact(art, device="cpu")
                               .count_frames(imgs), atol=0.006)
    with pytest.raises(SystemExit, match="cannot serve an --artifact"):
        main(["--config", str(cfg), "--task", "serve", "--frames", str(frames), "--artifact",
              art, "--quantize", "auto"])
    with pytest.raises(SystemExit, match="needs --frames"):
        main(["--config", str(cfg), "--task", "serve", "--http", "0", "--quantize"])
    with pytest.raises(SystemExit, match="requires a checkpoint"):
        main(["--config", str(bare), "--task", "quantize", "--frames", str(frames), "--out", art])
    with pytest.raises(SystemExit, match="requires --template"):
        main(["--config", str(cfg), "--task", "export"])
    for argv, why in ((["--task", "aot"], "requires --out FILE and --shapes"),
                      (["--task", "serve", "--frames", str(frames), "--aot", "m.aot"],
                       "no such file")):
        with pytest.raises(SystemExit, match=why):
            main(["--config", str(cfg), *argv])
