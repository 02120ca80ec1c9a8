"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Needs an NVIDIA Hopper GPU and nvcc; every test skips without a card.
On the card, run it without the JAX-side conftest (this file imports
torch and the port only):

    python -m pytest --noconftest -q tests/test_torch_port_cuda.py

Tolerances (TF32 off for the plain versions): f32 atol/rtol 1e-4 (the
f32 kernels sum in another order), 1e-3 for the training gradients (longer
sums, in another order); bf16 outputs against the plain version on the
same inputs 2e-2 (one bf16 rounding of the output, 2^-8 relative), the
training loss 1e-3 relative (p is exact f32 in both; f32 1e-4), also
where the views agree to 0.001, its
gradients 0.05 / 0.02 and dM to 0.02 in relative norm
(tests/test_mem_attention_train.py), and bf16 outputs and dy also to 1e-2
in relative norm (the kernel rounds dl to bf16, the plain version does
not). The gradients of the consistency loss alone: relative norm 1e-4 in
f32, 1e-2 in bf16. The density-map kernel: atol 1e-5 / rtol 1e-4 against
its plain version and the numpy golden (f32, other summation order). The
paths without a kernel of their own, in bf16 on the card against f32 on the
CPU: the joint step's loss parts 2e-2, the classic baselines' served counts
2e-2 of the map's mass; the Bayesian loss on the same values 1e-4. The int8
convolution (csrc/qconv.cu): its int32 accumulator against the float64
convolution, and its f32 and bf16 outputs against the plain epilogue on
that accumulator, bit for bit.
"""

import pytest
import torch

from dgvcc_tpu_torch.ops import mem_attention as ma
from dgvcc_tpu_torch.ops import mem_attention_train as mt

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; run on the card with "
                    "python -m pytest --noconftest tests/test_torch_port_cuda.py")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,p,k,s", [(2, 300, 16, 16), (2, 300, 64, 128),
                                     (1, 1000, 128, 1001), (3, 6437, 256, 1024)])
def test_kernel_matches_plain(cuda, dtype, tol, b, p, k, s):
    g = torch.Generator(device=cuda).manual_seed(b * p + k + s)
    y = torch.randn(b, p, k, generator=g, device=cuda).to(dtype)
    mem = torch.randn(k, s, generator=g, device=cuda).to(dtype)
    before = ma.LAUNCHES
    out = ma.memory_attention_fused(y, mem)
    torch.cuda.synchronize()
    assert ma.LAUNCHES == before + 1
    assert out.dtype == dtype and out.shape == y.shape
    ref = ma.memory_attention_reference(y.float(), mem.float())
    torch.testing.assert_close(out.float(), ref, atol=tol, rtol=tol)


# the bf16 kernel's edges: rows below one 128-row tile, the validation
# shape, S below one 64-prototype chunk, S % 8 != 0 at K=256 (M padded for
# its tensor map), and every width; held against the f32 plain version
@pytest.mark.parametrize("b,p,k,s", [(1, 37, 256, 1024), (1, 49152, 256, 1024),
                                     (2, 300, 256, 40), (1, 1000, 256, 1001),
                                     (2, 333, 16, 200), (2, 333, 32, 200),
                                     (2, 333, 64, 200), (2, 333, 128, 200),
                                     (2, 333, 256, 200)])
def test_bf16_kernel_edges_match_plain(cuda, b, p, k, s):
    g = torch.Generator(device=cuda).manual_seed(7 * b * p + k + s)
    y = torch.randn(b, p, k, generator=g, device=cuda).bfloat16()
    mem = torch.randn(k, s, generator=g, device=cuda).bfloat16()
    out = ma.memory_attention_fused(y, mem)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and out.shape == y.shape
    ref = ma.memory_attention_reference(y.float(), mem.float())
    torch.testing.assert_close(out.float(), ref, atol=2e-2, rtol=2e-2)


def test_bf16_kernel_is_deterministic(cuda):
    """No float atomics: two calls on the same inputs give the same bits."""
    g = torch.Generator(device=cuda).manual_seed(11)
    y = torch.randn(2, 6437, 256, generator=g, device=cuda).bfloat16()
    mem = torch.randn(256, 1001, generator=g, device=cuda).bfloat16()
    first = ma.memory_attention_fused(y, mem)
    second = ma.memory_attention_fused(y, mem)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_kernel_rejects_what_it_cannot_take(cuda):
    y = torch.randn(1, 8, 48, device=cuda)
    with pytest.raises(ValueError, match="K=48"):
        ma.memory_attention_fused(y, torch.randn(48, 32, device=cuda))
    with pytest.raises(TypeError):
        ma.memory_attention_fused(y[..., :32].half(),
                                  torch.randn(32, 32, device=cuda).half())
    with pytest.raises(ValueError, match="CUDA device"):
        ma.memory_attention_fused(y[..., :32], torch.randn(32, 32))


def test_dg_model_fused_matches_einsum_path(cuda):
    """Tiny DGModel final on the card: the kernel path against the einsum
    path, in f32 (TF32 off for both)."""
    import dgvcc_tpu_torch.models  # noqa: F401
    from dgvcc_tpu_torch.core.registry import MODELS

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    tiny = dict(vgg_cfg=(8, "M", 8, "M", 16, "M", 16, "M"),
                stage_splits=(0, 8, 12, 16),
                dec_widths=((16, 16), (16, 16), (16, 8)),
                mem_size=16, mem_dim=16)
    fused = MODELS.build("final", fused_mem=True, **tiny)
    fused.reset_parameters(torch.Generator().manual_seed(0))
    plain = MODELS.build("final", fused_mem=False, **tiny)
    plain.load_state_dict(fused.state_dict())
    x = torch.randn(2, 3, 64, 96, generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        d_f, c_f = fused.to(cuda).eval()(x.to(cuda))
        d_p, c_p = plain.to(cuda).eval()(x.to(cuda))
    torch.testing.assert_close(d_f, d_p, atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(c_f, c_p, atol=0, rtol=0)


def _train_objective(dtype):
    """f32: the asymmetric objective of tests/test_mem_attention_train.py
    (catches view sign errors); bf16: its non-cancelling one, whose two
    views' dM terms do not cancel into bf16 noise."""
    def f(out1, out2, con):
        if dtype == torch.float32:
            n = out1.numel()
            w = torch.arange(n, dtype=torch.float32, device=out1.device)
            return ((out1 * torch.cos(w).reshape(out1.shape)).sum()
                    + 0.5 * (out2 * torch.sin(w).reshape(out2.shape)).sum() + 10.0 * con)
        return out1.float().sum() + 0.5 * out2.float().sum() + 5.0 * con
    return f


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,p,k,s", [(2, 437, 16, 32), (2, 437, 16, 1001),
                                     (1, 300, 256, 1024), (3, 437, 256, 1001)])
def test_train_kernels_match_plain(cuda, dtype, b, p, k, s):
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=cuda).manual_seed(b * p + k + s)
    y1, y2 = (torch.randn(b, p, k, generator=g, device=cuda).to(dtype) for _ in range(2))
    mem = torch.randn(k, s, generator=g, device=cuda).to(dtype)
    obj = _train_objective(dtype)
    grads = {}
    for name, fn in (("kernel", mt.memory_attention_train),
                     ("plain", mt.memory_attention_train_reference)):
        a1, a2, m = (t.clone().requires_grad_() for t in (y1, y2, mem))
        before = (mt.FWD_LAUNCHES, mt.BWD_LAUNCHES)
        outs = fn(a1, a2, m)
        grads[name] = (outs, torch.autograd.grad(obj(*outs), (a1, a2, m)))
        torch.cuda.synchronize()
        launched = (mt.FWD_LAUNCHES - before[0], mt.BWD_LAUNCHES - before[1])
        assert launched == ((1, 1) if name == "kernel" else (0, 0))
    (o1, o2, con), (dy1, dy2, dm) = grads["kernel"]
    (r1, r2, rcon), (ry1, ry2, rdm) = grads["plain"]
    assert o1.dtype == dtype and dy1.dtype == dtype and dm.dtype == dtype
    if dtype == torch.float32:
        for a, r in ((o1, r1), (o2, r2)):
            torch.testing.assert_close(a, r, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(con, rcon, atol=0, rtol=1e-4)
        for a, r in ((dy1, ry1), (dy2, ry2), (dm, rdm)):
            torch.testing.assert_close(a, r, atol=1e-3, rtol=1e-3)
    else:
        for a, r in ((o1, r1), (o2, r2)):
            torch.testing.assert_close(a.float(), r.float(), atol=2e-2, rtol=2e-2)
            assert _rel_norm(a, r) <= 1e-2
        torch.testing.assert_close(con, rcon, atol=0, rtol=1e-3)
        for a, r in ((dy1, ry1), (dy2, ry2)):
            torch.testing.assert_close(a.float(), r.float(), atol=0.02, rtol=0.05)
            assert _rel_norm(a, r) <= 1e-2
        assert _rel_norm(dm, rdm) < 0.02


def _rel_norm(a, r):
    return ((a.float() - r.float()).norm() / r.float().norm().clamp_min(1e-30)).item()


def _dmap_points(h, w, n, seed):
    """n points over the image and a margin around it, a few on every
    border, some in (-1, 0) (truncated onto row / column 0) and some
    outside the image; the last quarter masked off as pad rows."""
    g = torch.Generator().manual_seed(seed)
    pts = torch.rand(n, 2, generator=g) * torch.tensor([w + 20.0, h + 20.0]) - 10.0
    if n >= 12:
        pts[:8] = torch.tensor([[0.0, 0.0], [w - 0.5, h - 0.5], [-0.4, h / 2],
                                [w / 2, -0.7], [w - 1.0, 3.0], [5.0, h - 1.0],
                                [w + 0.5, 2.0], [-1.5, 4.0]])
    mask = torch.ones(n, dtype=torch.bool)
    mask[3 * n // 4:] = False
    return pts, mask


@pytest.mark.parametrize("h,w,n", [(768, 1024, 1024), (1080, 1920, 4000), (768, 1024, 0),
                                   (17, 23, 40)])
def test_dmap_kernel_matches_plain(cuda, h, w, n):
    """Kernel #4 against its plain version (A . B^T, TF32 off) on the card:
    atol 1e-5, rtol 1e-4 (float32; the kernel sums the covering points in
    point order, the product in its own order)."""
    from dgvcc_tpu_torch.ops import dmap

    torch.backends.cuda.matmul.allow_tf32 = False
    pts, mask = _dmap_points(h, w, n, seed=h + w + n)
    before = dmap.LAUNCHES
    out = dmap.gaussian_density(pts.to(cuda), mask.to(cuda), h, w)
    torch.cuda.synchronize()
    assert dmap.LAUNCHES == before + 1
    assert out.shape == (h, w) and out.dtype == torch.float32
    ref = dmap.gaussian_density_reference(pts.to(cuda), mask.to(cuda), h, w)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-4)
    golden = dmap.gaussian_density_fixed_np((h, w), pts[mask].numpy())
    torch.testing.assert_close(out.cpu(), torch.from_numpy(golden), atol=1e-5, rtol=1e-4)


def test_dmap_kernel_rejects_what_it_cannot_take(cuda):
    from dgvcc_tpu_torch.ops import dmap

    pts, mask = _dmap_points(10, 10, 16, seed=0)
    with pytest.raises(TypeError):
        dmap.gaussian_density(pts.double().to(cuda), mask.to(cuda), 10, 10)
    with pytest.raises(ValueError, match="CUDA device"):
        dmap.gaussian_density(pts.to(cuda), mask, 10, 10)
    with pytest.raises(ValueError, match="radius"):
        dmap.gaussian_density(pts.to(cuda), mask.to(cuda), 10, 10, sigma=40.0)


def _dmap_binned_case(kind, h, w, n, seed):
    """Points of kernel #4's timed and edge shapes (chip_smoke.py's
    DMAP_CASES): uniform in the image; 50 Gaussian blobs of sigma 40-120 px
    plus 10% uniform; all inside the tile at (320, 320); or _dmap_points."""
    if kind == "border":
        return _dmap_points(h, w, n, seed)
    g = torch.Generator().manual_seed(seed)
    size = torch.tensor([w - 1.0, h - 1.0])
    if kind == "uniform":
        pts = torch.rand(n, 2, generator=g) * size
    elif kind == "clustered":
        k = n - n // 10
        centres = torch.rand(50, 2, generator=g) * size
        spread = 40.0 + 80.0 * torch.rand(50, 1, generator=g)
        blob = torch.randint(50, (k,), generator=g)
        pts = torch.cat([centres[blob] + spread[blob] * torch.randn(k, 2, generator=g),
                         torch.rand(n - k, 2, generator=g) * size])
        pts = torch.minimum(pts.clamp_min(0.0), size)
    else:
        pts = 320.0 + 31.99 * torch.rand(n, 2, generator=g)
    return pts, torch.ones(n, dtype=torch.bool)


@pytest.mark.parametrize("case", [
    ("S1", 768, 1024, 1024, "uniform", 4.0, 7 / 4),
    ("S2", 2048, 3072, 25000, "clustered", 4.0, 7 / 4),
    ("overflow_tile", 768, 1024, 4096, "one_tile", 4.0, 7 / 4),
    ("radius_63", 768, 1024, 1024, "border", 16.0, 3.95)], ids=lambda c: c[0])
def test_dmap_kernel_binned_cases_match_plain_bit_for_bit(cuda, case):
    """Kernel #4 at the 768x1024 frame, at 2048x3072 with 25,000 clustered
    points, with 4,096 points in one tile (more than a splat block's
    buffer: rounds) and at radius 63 (windows two tiles each way): against
    its plain version (atol 1e-5, rtol 1e-4), and a second call bit for bit
    (no float atomics)."""
    from dgvcc_tpu_torch.ops import dmap

    torch.backends.cuda.matmul.allow_tf32 = False
    _, h, w, n, kind, sigma, truncate = case
    pts, mask = _dmap_binned_case(kind, h, w, n, seed=n + h)
    pts, mask = pts.to(cuda), mask.to(cuda)
    before = dmap.LAUNCHES
    out = dmap.gaussian_density(pts, mask, h, w, sigma, truncate)
    again = dmap.gaussian_density(pts, mask, h, w, sigma, truncate)
    torch.cuda.synchronize()
    assert dmap.LAUNCHES == before + 2
    assert torch.equal(out, again)
    ref = dmap.gaussian_density_reference(pts, mask, h, w, sigma, truncate)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("sigma", [8.0, 2.0])
def test_dmap_cli_cuda_backend_writes_radius_7_at_any_sigma(cuda, tmp_path, sigma, capsys):
    """dmap_cli's default backend (kernel #4) writes the numpy golden's maps,
    radius 7 whatever --sigma (truncate 7 / sigma)."""
    import numpy as np
    from PIL import Image

    from dgvcc_tpu_torch.data import dmap_cli
    from dgvcc_tpu_torch.ops import dmap

    (tmp_path / "train").mkdir()
    rng = np.random.default_rng(3)
    shapes = {"a": (48, 64), "b": (70, 33)}
    for name, (h, w) in shapes.items():
        Image.fromarray(np.zeros((h, w, 3), np.uint8)).save(tmp_path / "train" / f"{name}.jpg")
        pts = rng.uniform(-3, [w + 3, h + 3], (25, 2)).astype(np.float32)
        np.save(tmp_path / "train" / f"{name}.npy", pts)
    dmap_cli.main(["--path", str(tmp_path), "--phases", "train", "--sigma", str(sigma)])
    assert "2 of 2 images done" in capsys.readouterr().out
    for name, (h, w) in shapes.items():
        got = np.load(tmp_path / "train" / f"{name}_dmap.npy")
        want = dmap.gaussian_density_fixed_np(
            (h, w), np.load(tmp_path / "train" / f"{name}.npy"), sigma)
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("b,p,k,s", [(2, 437, 16, 32), (2, 437, 16, 1001),
                                     (3, 437, 256, 1001), (16, 6400, 256, 1024)])
def test_train_kernels_loss_branch_matches_plain(cuda, dtype, tol, b, p, k, s):
    """The gradients of loss_con alone, scaled by rows x S (cotangent g =
    rows x S, so dp = +-2 (p1 - p2)): dy1, dy2 and dM come from the
    consistency branch of the backward only, which the mixed objective
    above scales below its tolerances. Relative norm: f32 sums in another
    order; bf16 dl is rounded once in the kernel and not in the plain
    version."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=cuda).manual_seed(b * p + k + s + 1)
    y1, y2 = (torch.randn(b, p, k, generator=g, device=cuda).to(dtype) for _ in range(2))
    mem = torch.randn(k, s, generator=g, device=cuda).to(dtype)
    grads = {}
    for name, fn in (("kernel", mt.memory_attention_train),
                     ("plain", mt.memory_attention_train_reference)):
        leaves = [t.clone().requires_grad_() for t in (y1, y2, mem)]
        con = fn(*leaves)[2]
        grads[name] = torch.autograd.grad(con * float(b * p * s), leaves)
    for name, a, r in zip(("dy1", "dy2", "dM"), grads["kernel"], grads["plain"]):
        assert a.dtype == dtype and r.norm() > 0, name
        assert _rel_norm(a, r) <= tol, (name, _rel_norm(a, r))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,p,k,s", [(2, 437, 16, 1001), (3, 6437, 256, 1024),
                                     (16, 6400, 256, 1024)])
def test_train_forward_saves_lse_and_q(cuda, dtype, b, p, k, s):
    """What the forward kernel saves for the backward's D rule against its
    plain version (float32, TF32 off): each row's logsumexp and q = (<p1,
    p1>, <p2, p2>, <p1, p2>)_S, atol 1e-5 / rtol 1e-4 (sums in another
    order; the bf16 kernel takes exp on the SFU)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=cuda).manual_seed(b + p + k + s)
    y1, y2 = (torch.randn(b, p, k, generator=g, device=cuda).to(dtype) for _ in range(2))
    mem = torch.randn(k, s, generator=g, device=cuda).to(dtype)
    lse, q = mt.memory_attention_train_forward(y1, y2, mem)[3:]
    want_lse, want_q = mt.saved_reference(y1, y2, mem)
    assert lse.shape == (2, b * p) and q.shape == (3, b * p)
    torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(q, want_q, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("eps", [0.1, 0.01, 0.001])
@pytest.mark.parametrize("b,p,k,s", [(2, 437, 16, 1001), (3, 6437, 256, 1024)])
def test_train_forward_holds_views_that_agree(cuda, dtype, eps, b, p, k, s):
    """y2 = y1 + eps N(0, 1): loss_con falls to ~1e-9 of the q sums, and the
    bf16 forward's one sweep must not form it as their difference. loss_con
    to 1e-3 relative (f32 1e-4), q relative 1e-4 (f32 1e-5), two calls bit
    for bit, one launch each."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=cuda).manual_seed(b * p + k + s + int(1 / eps))
    y1 = torch.randn(b, p, k, generator=g, device=cuda)
    y2 = (y1 + eps * torch.randn(b, p, k, generator=g, device=cuda)).to(dtype)
    y1 = y1.to(dtype)
    mem = torch.randn(k, s, generator=g, device=cuda).to(dtype)
    before = mt.FWD_LAUNCHES
    got = mt.memory_attention_train_forward(y1, y2, mem)
    again = mt.memory_attention_train_forward(y1, y2, mem)
    torch.cuda.synchronize()
    assert mt.FWD_LAUNCHES == before + 2
    for name, a, r in zip(("out1", "out2", "loss_con", "lse", "q"), got, again):
        assert torch.equal(a, r), name
    rcon = mt.memory_attention_train_reference(y1, y2, mem)[2]
    lse, q = mt.saved_reference(y1, y2, mem)
    bf16 = dtype == torch.bfloat16
    torch.testing.assert_close(got[2], rcon, atol=0, rtol=1e-3 if bf16 else 1e-4)
    torch.testing.assert_close(got[3], lse, atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(got[4], q, atol=0, rtol=1e-4 if bf16 else 1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_train_backward_is_deterministic(cuda, dtype):
    """dy1, dy2 and dM bit for bit across two calls of the backward (no
    float atomics: the dM partials are summed in a fixed order)."""
    g = torch.Generator(device=cuda).manual_seed(11)
    y1, y2, do1, do2 = (torch.randn(3, 6437, 256, generator=g, device=cuda).to(dtype)
                        for _ in range(4))
    mem = torch.randn(256, 1024, generator=g, device=cuda).to(dtype)
    out1, out2, _, lse, q = mt.memory_attention_train_forward(y1, y2, mem)
    dcon = torch.tensor(7.0, device=cuda)
    first, second = (mt.memory_attention_train_backward(y1, y2, mem, lse, q, out1, out2,
                                                         do1, do2, dcon) for _ in range(2))
    for name, a, b in zip(("dy1", "dy2", "dM"), first, second):
        assert torch.equal(a, b), name


def test_train_kernels_reject_what_they_cannot_take(cuda):
    y = torch.randn(1, 8, 32, device=cuda)
    with pytest.raises(ValueError, match="K=32"):
        mt.memory_attention_train(y, y, torch.randn(32, 16, device=cuda))
    with pytest.raises(TypeError):
        mt.memory_attention_train(y[..., :16].bfloat16(), y[..., :16].bfloat16(),
                                  torch.randn(16, 16, device=cuda))
    with pytest.raises(ValueError, match="CUDA device"):
        mt.memory_attention_train(y[..., :16], y[..., :16], torch.randn(16, 16))


def test_dg_forward_train_kernels_match_einsum_path(cuda):
    """Tiny DGModel final trained one forward/backward on the card: the
    training kernels against the bank's einsum path (fused_mem_train=False),
    in f32 with TF32 off, from the same weights. Gradients are compared by
    relative norm at 1e-4: cuDNN's backward sums in an order that changes
    from run to run, so two runs of one path differ at that level too. A VGG
    conv bias feeds a train-mode BN, so its exact gradient is 0 and its
    computed one is that noise on both paths: it is held to being
    negligible beside its conv's weight gradient."""
    import dgvcc_tpu_torch.models  # noqa: F401
    from dgvcc_tpu_torch.core.registry import MODELS

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    tiny = dict(vgg_cfg=(8, "M", 8, "M", 16, "M", 16, "M"), stage_splits=(0, 8, 12, 16),
                dec_widths=((16, 16), (16, 16), (16, 8)), mem_size=16, mem_dim=16,
                den_dropout=0.0, cls_dropout=0.0)
    g = torch.Generator().manual_seed(3)
    img1 = torch.randn(2, 3, 64, 64, generator=g)
    img2 = img1 + 0.1 * torch.randn(2, 3, 64, 64, generator=g)
    c_gt = (torch.rand(2, 1, 4, 4, generator=g) > 0.5).float()
    results = []
    for fused in (True, False):
        m = MODELS.build("final", fused_mem_train=fused, **tiny)
        m.reset_parameters(torch.Generator().manual_seed(0))
        m.to(cuda).train()
        before = mt.FWD_LAUNCHES, mt.BWD_LAUNCHES
        out = m.forward_train(img1.to(cuda), img2.to(cuda), c_gt.to(cuda))
        (out[0].sum() + 0.5 * out[1].sum() + out[2].sum() + out[3].sum()
         + 10.0 * out[5]).backward()
        torch.cuda.synchronize()
        launched = (mt.FWD_LAUNCHES - before[0], mt.BWD_LAUNCHES - before[1])
        assert launched == ((1, 1) if fused else (0, 0))
        results.append((out, {n: p.grad for n, p in m.named_parameters()}))
    noise = {f"{n}.bias" for n, mod in m.named_modules()
             if isinstance(mod, torch.nn.Conv2d) and mod.bias is not None}
    (out_k, grads_k), (out_e, grads_e) = results
    for a, b in zip(out_k, out_e):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-4)
    for n, ge in grads_e.items():
        gk = grads_k[n]
        assert gk is not None and ge is not None, n
        if n in noise:
            scale = grads_e[n[:-len("bias")] + "weight"].abs().max()
            assert max(gk.abs().max(), ge.abs().max()) <= 1e-5 * scale, n
        else:
            rel = ((gk - ge).norm() / ge.norm()).item()
            assert rel <= 1e-4, (n, rel)


# ---- data on the card and the training extras (no kernel of their own):
# the card's results against the same code on the CPU

@pytest.mark.parametrize("b,pre,crop", [(16, 384, 320), (3, 200, 128)])
def test_device_aug_on_the_card_matches_the_cpu(cuda, b, pre, crop):
    """Injected draws: the batched augmentation on the card against the
    CPU (f32, atol 1e-5: the card contracts a * b + c into FMAs)."""
    from dgvcc_tpu_torch.data import device_pipeline as dp

    g = torch.Generator(device=cuda).manual_seed(b + pre)
    frames = torch.randint(0, 256, (b, pre, pre, 3), generator=g, device=cuda,
                           dtype=torch.uint8)
    dmaps = torch.rand((b, pre, pre, 1), generator=g, device=cuda)
    draws = dp.draw_augmentation(b, pre, pre, crop, g)
    got = dp.apply_augmentation(frames, dmaps, draws, crop)
    want = dp.apply_augmentation(frames.cpu(), dmaps.cpu(),
                                 {k: v.cpu() for k, v in draws.items()}, crop)
    for k, w in want.items():
        assert got[k].is_contiguous(memory_format=torch.channels_last), k
        torch.testing.assert_close(got[k].cpu(), w, atol=1e-5, rtol=0)


def test_accumulation_ema_and_async_save_on_the_card(cuda, tmp_path):
    """accum_steps 3 with EMA on the card: the parameters hold inside the
    window, the card's update and shadow match the CPU's (1e-6), and an
    async save written from the card equals a sync save."""
    from dgvcc_tpu_torch.train.checkpoint import (AsyncWriter, CheckpointRotator,
                                                  save_checkpoint, sidecar_path)
    from dgvcc_tpu_torch.train.state import create_train_state

    spec = {"name": "adamw", "params": {"lr": 1e-2, "weight_decay": 1e-2}}
    states = []
    for dev in ("cpu", "cuda"):
        torch.manual_seed(0)
        model = torch.nn.Sequential(torch.nn.Conv2d(3, 8, 3), torch.nn.BatchNorm2d(8))
        states.append(create_train_state(model, spec, device=dev, accum_steps=3, ema=0.9))
    g = torch.Generator().manual_seed(1)
    grads = [[torch.randn(p.shape, generator=g) for p in states[0].model.parameters()]
             for _ in range(4)]
    for m, gs in enumerate(grads, 1):
        for st in states:
            before = [p.detach().clone() for p in st.model.parameters()]
            for p, x in zip(st.model.parameters(), gs):
                p.grad = x.to(p.device)
            st.apply_gradients()
            held = all(torch.equal(a, p) for a, p in zip(before, st.model.parameters()))
            assert held == (m != 3), m
    for a, b in zip(states[0].model.parameters(), states[1].model.parameters()):
        torch.testing.assert_close(b.detach().cpu(), a.detach(), atol=1e-7, rtol=1e-6)
    for k, e in states[0].ema_params.items():
        torch.testing.assert_close(states[1].ema_params[k].cpu(), e, atol=1e-7, rtol=1e-6)
    st = states[1]
    writer = AsyncWriter()
    CheckpointRotator(str(tmp_path), writer=writer).save_last(st, {"epoch": 1})
    writer.close()
    save_checkpoint(str(tmp_path / "sync.pth"), st, {"epoch": 1})
    for a, b in ((tmp_path / "last.pth", tmp_path / "sync.pth"),
                 (sidecar_path(str(tmp_path / "last.pth")),
                  sidecar_path(str(tmp_path / "sync.pth")))):
        x, y = torch.load(a, weights_only=True), torch.load(b, weights_only=True)
        flat_x = x if "optimizer" not in x else {**x["ema"], **x["accum"]["acc_grads"]}
        flat_y = y if "optimizer" not in y else {**y["ema"], **y["accum"]["acc_grads"]}
        for k in flat_x:
            assert torch.equal(flat_x[k], flat_y[k]), k


# ---- the generator's joint step, the classic baselines, the Bayesian loss:
# the card in bf16 (f32 AdamW master weights) against the CPU in f32, at the
# bf16 tolerances of chip_smoke.py phase 11

def _seeded_dropout(monkeypatch):
    """Both devices' dropout2d keep the channels of seeded mask i at their
    i-th call (a torch.Generator draws other numbers on each device)."""
    import numpy as np

    from dgvcc_tpu_torch.models import regressors as preg
    from dgvcc_tpu_torch.nn import layers as players

    orig = players.dropout2d
    calls = [0]

    def drop(x, rate, generator=None, mask=None):
        if rate == 0.0:
            return x
        m = np.random.default_rng(5000 + calls[0] % 4).random((x.shape[0], x.shape[1]))
        calls[0] += 1
        return orig(x, rate, mask=torch.from_numpy(m < 1.0 - rate))

    for mod in (players, preg):
        monkeypatch.setattr(mod, "dropout2d", drop)


def test_joint_step_on_the_card_matches_the_cpu(cuda, monkeypatch):
    """One joint step (tiny gen and reg_mem, B=2 of 64^2): each loss part
    within 2e-2 of the CPU's f32 step from the same weights."""
    from dgvcc_tpu_torch.core.registry import LOSSES, MODELS
    from dgvcc_tpu_torch.train.genjoint import build_joint_step
    from dgvcc_tpu_torch.train.state import create_train_state

    _seeded_dropout(monkeypatch)
    tiny_vgg19 = (8, "M", 8, "M", 16, "M")
    tiny_vgg = (8, "M", 8, "M", 16, "M", 16, "M")
    kw = {"gen": dict(vgg_cfg=tiny_vgg19, enc_stop=9),
          "reg_mem": dict(vgg_cfg=tiny_vgg, stage_splits=(0, 8, 12, 16), part_num=16,
                          dec_widths=((16, 16), (16, 16), (16, 8)), final_dim=16)}
    g = torch.Generator().manual_seed(0)
    batch = {"img1": torch.tanh(torch.randn(2, 3, 64, 64, generator=g)),
             "img2": torch.tanh(torch.randn(2, 3, 64, 64, generator=g)),
             "dmap": torch.rand(2, 1, 64, 64, generator=g) * 2e-3,
             "bmap": (torch.rand(2, 1, 4, 4, generator=g) < 0.6).float()}
    out = {}
    for dev, dtype in (("cpu", torch.float32), ("cuda", torch.bfloat16)):
        models = []
        for name in ("gen", "reg_mem"):
            m = MODELS.build(name, dtype=dtype, **kw[name])
            m.reset_parameters(torch.Generator().manual_seed(3))
            models.append(m)
        states = [create_train_state(m, {"name": "adamw"}, device=dev) for m in models]
        step = build_joint_step(*models, LOSSES.build("mse"), 1000.0)
        _, _, metrics = step(*states, {k: v.to(dev) for k, v in batch.items()}, None)
        out[dev] = {k: float(v) for k, v in metrics.items()}
    for k, want in out["cpu"].items():
        assert abs(out["cuda"][k] - want) <= 2e-2 * abs(want), (k, out["cuda"][k], want)


@pytest.mark.parametrize("name,params", [
    ("csrnet", {}), ("mcnn", {}), ("bl", {}), ("sasnet", {}), ("dssinet", {}),
    ("cctrans", dict(embed_dims=(32, 64, 128, 256), num_heads=(2, 4, 8, 16),
                     depths=(1, 1, 2, 1), wss=(4, 4, 4, 4), sr_ratios=(8, 4, 2, 1)))])
def test_baseline_serving_on_the_card_matches_the_cpu(cuda, name, params):
    """count_frames of two 128x160 frames: bf16 on the card within 2e-2 of
    the map's mass of the same seeded weights in f32 on the CPU."""
    import numpy as np

    from dgvcc_tpu_torch.serve import VideoCounter

    frames = np.random.default_rng(6).integers(0, 256, (2, 128, 160, 3), dtype=np.uint8)
    card = VideoCounter.from_checkpoint(name, None, dtype=torch.bfloat16, seed=4, **params)
    host = VideoCounter.from_checkpoint(name, None, dtype=torch.float32, device="cpu", seed=4,
                                        **params)
    got, want = card.count_frames(frames), host.count_frames(frames)
    mass = VideoCounter(_Abs(host.model), dtype=torch.float32, device="cpu").count_frames(frames)
    assert np.isfinite(got).all()
    assert float(np.abs(got - want).max()) <= 2e-2 * max(float(mass.max()), 1.0), (got, want)


class _Abs(torch.nn.Module):
    """A model's density map, |.|: its count is the map's mass."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, x):
        return self.model(x).abs()


def test_bayesian_loss_on_the_card_matches_the_cpu(cuda):
    """The bl loss and its gradient on a stride-8 prediction rounded to bf16
    (B=8, 40x40, up to 320 points), the card against the CPU on the same
    values: 1e-4."""
    from dgvcc_tpu_torch.losses.bayesian import BayesianLoss

    g = torch.Generator().manual_seed(7)
    pts = torch.rand(8, 320, 2, generator=g) * 360 - 20
    msk = torch.arange(320)[None] < torch.tensor([0, 1, 5, 40, 100, 200, 300, 320])[:, None]
    tgt = torch.rand(8, 320, generator=g) * msk
    st = 320 + torch.rand(8, generator=g) * 300
    pred = (torch.rand(8, 1, 40, 40, generator=g) * 0.05).to(torch.bfloat16)
    out = {}
    for dev in ("cpu", "cuda"):
        p = pred.float().to(dev).requires_grad_()
        loss = BayesianLoss(sigma=8.0, c_size=320)(pts.to(dev), msk.to(dev), tgt.to(dev),
                                                   st.to(dev), p)
        loss.backward()
        out[dev] = (loss.detach().cpu(), p.grad.float().cpu())
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-4, atol=0)
    torch.testing.assert_close(out["cuda"][1], out["cpu"][1], rtol=1e-4, atol=1e-6)


# ---- data parallel on the card: ranks spawned by parallel/launch.py (gloo
# on cuda:0 with one card, NCCL with a card a rank on two or more), held at
# chip_smoke.py phase 12's tolerances: loss 1e-3, gradients 1e-2 in relative
# norm, statistics 1e-3

DP_TINY = dict(vgg_cfg=(8, "M", 8, "M", 16, "M", 16, "M"), stage_splits=(0, 8, 12, 16),
               dec_widths=((16, 16), (16, 16), (16, 8)), mem_size=16, mem_dim=16,
               den_dropout=0.0, cls_dropout=0.0, err_thrs=1e9, cls_thrs=-1.0)
DP_SGD = {"name": "sgd", "params": {"lr": 0.01}}


def _dp_model(device, bank_group=None):
    """A tiny `final`'s SGD state; with ``bank_group`` its bank sharded over
    that group first."""
    import dgvcc_tpu_torch.models  # noqa: F401
    from dgvcc_tpu_torch.core.registry import MODELS
    from dgvcc_tpu_torch.parallel import tp
    from dgvcc_tpu_torch.train.state import create_train_state

    m = MODELS.build("final", **DP_TINY)
    m.reset_parameters(torch.Generator().manual_seed(0))
    if bank_group is not None:
        tp.shard_model_bank(m, bank_group)
    return create_train_state(m, DP_SGD, device=device)


def _dp_inputs():
    g = torch.Generator().manual_seed(5)
    img1 = torch.randn(4, 3, 64, 64, generator=g)
    return {"x": torch.randn(4, 8, 6, 6, generator=g) + 0.3,
            "w": torch.randn(4, 8, 6, 6, generator=g),
            "batch": {"img1": img1, "img2": img1 + 0.1 * torch.randn(4, 3, 64, 64, generator=g),
                      "dmap": torch.rand(4, 1, 64, 64, generator=g) * 2e-3,
                      "bmap": (torch.rand(4, 1, 4, 4, generator=g) > 0.5).float()}}


def _dp_card_rank(rank, workdir):
    import os

    import torch.distributed as dist

    import dgvcc_tpu_torch.losses  # noqa: F401
    from dgvcc_tpu_torch.core.registry import LOSSES
    from dgvcc_tpu_torch.nn.layers import BatchNorm2d
    from dgvcc_tpu_torch.parallel import mesh

    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    world = dist.get_world_size()
    group = mesh.make_mesh(world)
    inp = _dp_inputs()
    rows = mesh.shard_rows(4, rank, world)
    bn = BatchNorm2d(8).to(dev)
    bn.process_group = group
    x = inp["x"][rows].to(dev).requires_grad_()
    y = bn(x)
    (y * inp["w"][rows].to(dev)).sum().backward()
    out = {"bn": (y.detach().cpu(), x.grad.cpu(), bn.running_mean.cpu(), bn.running_var.cpu())}
    state = _dp_model(dev)
    step = mesh.build_parallel_train_step(state.model, LOSSES.build("mse"), "final", 1000.0,
                                          group)
    before = mt.FWD_LAUNCHES, mt.BWD_LAUNCHES
    batch = mesh.shard_batch({k: v.to(dev) for k, v in inp["batch"].items()}, rank, world)
    _, metrics = step(state, batch, None, 0)
    out["launches"] = (mt.FWD_LAUNCHES - before[0], mt.BWD_LAUNCHES - before[1])
    out["metrics"] = {k: float(v) for k, v in mesh.average_metrics(metrics, group).items()}
    out["grads"] = {n: p.grad.float().cpu() for n, p in state.model.named_parameters()}
    out["stats"] = {n: b.float().cpu() for n, b in state.model.named_buffers()
                    if "running" in n}
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))


def test_data_parallel_on_two_ranks_matches_the_full_batch_and_the_halves(cuda, tmp_path):
    """2 ranks: the synced BatchNorm2d against nn.BatchNorm2d on the whole
    batch; a tiny `final`'s DP step (kernels #2, #3 on each rank) against
    its two halves run in turn here from the same weights, averaged."""
    import dgvcc_tpu_torch.losses  # noqa: F401
    from dgvcc_tpu_torch.core.registry import LOSSES
    from dgvcc_tpu_torch.parallel.launch import run_ranks
    from dgvcc_tpu_torch.train.steps import build_loss_fn

    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    backend = "nccl" if torch.cuda.device_count() >= 2 else "gloo"
    run_ranks(_dp_card_rank, 2, (str(tmp_path),), init_file=str(tmp_path / "init"),
              backend=backend, timeout=300)
    got = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(2)]
    inp = _dp_inputs()
    bn = torch.nn.BatchNorm2d(8).to(cuda)
    x = inp["x"].to(cuda).requires_grad_()
    y = bn(x)
    (y * inp["w"].to(cuda)).sum().backward()
    y_dp = torch.cat([g["bn"][0] for g in got])
    dx_dp = torch.cat([g["bn"][1] for g in got])
    for a, b in ((y_dp, y), (dx_dp, x.grad), (got[0]["bn"][2], bn.running_mean),
                 (got[0]["bn"][3], bn.running_var)):
        assert (a - b.detach().cpu()).abs().max() <= 1e-3 * b.abs().max()

    state = _dp_model(cuda)
    loss_fn = build_loss_fn(state.model, LOSSES.build("mse"), "final", 1000.0)
    start = {k: v.clone() for k, v in state.model.state_dict().items()}
    halves = []
    for r in range(2):
        state.model.load_state_dict(start)
        state.model.zero_grad(set_to_none=True)
        total, metrics = loss_fn({k: v[2 * r:2 * r + 2].to(cuda)
                                  for k, v in inp["batch"].items()}, None, 0)
        total.backward()
        halves.append(({k: float(v.detach()) for k, v in metrics.items()},
                       {n: p.grad.float().cpu() for n, p in state.model.named_parameters()},
                       {n: b.float().cpu() for n, b in state.model.named_buffers()
                        if "running" in n}))
    for g in got:
        assert g["launches"] == (1, 1)
    for k, v in got[0]["metrics"].items():
        want = (halves[0][0][k] + halves[1][0][k]) / 2
        assert abs(v - want) <= 1e-3 * max(abs(want), 1e-6), k
    num = sum(float((got[0]["grads"][n] - (halves[0][1][n] + halves[1][1][n]) / 2).norm() ** 2)
              for n in halves[0][1])
    den = sum(float(((halves[0][1][n] + halves[1][1][n]) / 2).norm() ** 2) for n in halves[0][1])
    assert (num / den) ** 0.5 <= 1e-2
    for n, b in got[0]["stats"].items():
        want = (halves[0][2][n] + halves[1][2][n]) / 2
        assert (b - want).abs().max() <= 1e-3 * want.abs().max(), n
        assert torch.equal(b, got[1]["stats"][n])


def _halo_card_rank(rank, workdir):
    """A halo convolution and a bilinear x4 on this rank's rows, on the card."""
    import os

    import torch.distributed as dist

    from dgvcc_tpu_torch.nn.collectives import halo_transport
    from dgvcc_tpu_torch.nn.layers import upsample
    from dgvcc_tpu_torch.parallel import spatial

    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    group = spatial.make_spatial_mesh(dist.get_world_size())
    conv = _halo_conv().to(dev)
    conv.spatial_group = group
    x_all, w_all = _halo_inputs()
    per = x_all.shape[2] // 2
    x = x_all[:, :, rank * per:(rank + 1) * per].to(dev).requires_grad_()
    y = upsample(conv(x), 4, group=group)
    (y * w_all[:, :, 4 * rank * per:4 * (rank + 1) * per].to(dev)).sum().backward()
    torch.save({"y": y.detach().cpu(), "dx": x.grad.cpu(),
                "transport": halo_transport(group, dev)},
               os.path.join(workdir, f"rank{rank}.pt"))


def _halo_conv():
    from dgvcc_tpu_torch.nn.layers import Conv2d

    conv = Conv2d(8, 16, 3, padding=1, bias=True)
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        conv.weight.copy_(0.2 * torch.randn(conv.weight.shape, generator=g))
        conv.bias.copy_(0.1 * torch.randn(16, generator=g))
    return conv


def _halo_inputs():
    g = torch.Generator().manual_seed(4)
    return torch.randn(2, 8, 64, 48, generator=g), torch.randn(2, 16, 256, 192, generator=g)


def test_halo_conv_on_two_ranks_matches_the_whole_tensor(cuda, tmp_path):
    """2 spatial ranks: a 3x3 convolution with halo rows and a bilinear x4
    upsample, each on its rows, against the whole tensor on one card; f32,
    TF32 off: output and input gradient 1e-4 (phase 13's f32 gate)."""
    from dgvcc_tpu_torch.nn.layers import upsample
    from dgvcc_tpu_torch.parallel.launch import run_ranks

    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    backend = "nccl" if torch.cuda.device_count() >= 2 else "gloo"
    run_ranks(_halo_card_rank, 2, (str(tmp_path),), init_file=str(tmp_path / "init"),
              backend=backend, timeout=300)
    got = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(2)]
    x_all, w_all = _halo_inputs()
    x = x_all.to(cuda).requires_grad_()
    y = upsample(_halo_conv().to(cuda)(x), 4)
    (y * w_all.to(cuda)).sum().backward()
    for a, b in ((torch.cat([g["y"] for g in got], dim=2), y.detach()),
                 (torch.cat([g["dx"] for g in got], dim=2), x.grad)):
        assert (a - b.cpu()).abs().max() <= 1e-4 * b.abs().max()
    assert backend in got[0]["transport"]


def _tp_card_rank(rank, workdir):
    """A tiny `final`'s 2-D step (data 2 x model 2) and its 1-D step over the
    data group, on the card: metrics and gradients, the bank gathered."""
    import os

    import dgvcc_tpu_torch.losses  # noqa: F401
    from dgvcc_tpu_torch.core.registry import LOSSES
    from dgvcc_tpu_torch.parallel import mesh, tp

    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    m2 = mesh.make_mesh_2d(2, 2)
    batch = mesh.shard_batch({k: v.to(dev) for k, v in _dp_inputs()["batch"].items()},
                             m2.data_index, 2)
    out = {}
    for label in ("2d", "1d"):
        state = _dp_model(dev, m2.model if label == "2d" else None)
        if label == "2d":
            step = mesh.build_parallel_train_step_2d(state.model, LOSSES.build("mse"), "final",
                                                     1000.0, m2)
        else:
            step = mesh.build_parallel_train_step(state.model, LOSSES.build("mse"), "final",
                                                  1000.0, m2.data)
        _, metrics = step(state, batch, None, 0)
        grads = {n: p.grad.float().cpu() for n, p in state.model.named_parameters()}
        if label == "2d":
            grads["mem"] = tp.gather_bank(state.model.mem.grad, m2.model).float().cpu()
        out[label] = ({k: float(v) for k, v in mesh.average_metrics(metrics, m2.data).items()},
                      grads)
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))


def test_2d_step_on_four_ranks_matches_the_1d_step(cuda, tmp_path):
    """4 ranks (data 2 x model 2) on the card: the 2-D step of a tiny
    `final` against the 1-D step over the data group from the same weights;
    f32, TF32 off: loss parts 1e-4, gradients 1e-3 in relative norm with the
    bank reassembled (phase 13's f32 gates)."""
    from dgvcc_tpu_torch.parallel.launch import run_ranks

    backend = "nccl" if torch.cuda.device_count() >= 4 else "gloo"
    run_ranks(_tp_card_rank, 4, (str(tmp_path),), init_file=str(tmp_path / "init"),
              backend=backend, timeout=300)
    for r in range(4):
        got = torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
        (m2, g2), (m1, g1) = got["2d"], got["1d"]
        for k, v in m1.items():
            assert abs(m2[k] - v) <= 1e-4 * max(abs(v), 1e-6), k
        num = sum(float((g2[n] - g1[n]).norm() ** 2) for n in g1)
        den = sum(float(g1[n].norm() ** 2) for n in g1)
        assert (num / den) ** 0.5 <= 1e-3


# the int8 convolution's edges: Cin 3 (enc1/conv0's) and 67 (padded to 16
# and 80 for the tensor maps), 16 and 32 (32-byte K steps), 192 (three
# 64-byte chunks); Cout 1, 8, 67 and 300 (ragged channel tiles of 64, 128,
# 256); H and W that the 2 x 64, 4 x 32, ... pixel tiles do not divide (W
# 100, 130: a ragged second or third tile); a 1x1 image; 1x1 windows;
# dilation 2 (CSRNet's back end); N = 3; rows below one 128-pixel tile
QCONV_EDGES = [(1, 37, 53, 3, 64, 3, 1), (2, 17, 9, 16, 1, 3, 1), (1, 31, 29, 67, 67, 3, 1),
               (2, 33, 35, 64, 67, 1, 1), (1, 45, 39, 128, 96, 3, 2), (1, 5, 7, 512, 512, 3, 1),
               (3, 1, 1, 64, 8, 3, 2), (2, 45, 100, 64, 64, 3, 1), (1, 19, 70, 32, 64, 3, 1),
               (1, 24, 40, 256, 300, 3, 1), (1, 13, 21, 192, 128, 3, 1),
               (3, 50, 130, 128, 130, 3, 2)]


def _qconv_case(device, n, h, w, cin, cout, k, seed):
    g = torch.Generator().manual_seed(seed)
    xq = torch.randint(-127, 128, (n, h, w, cin), generator=g, dtype=torch.int8)
    w8 = torch.randint(-127, 128, (cout, k, k, cin), generator=g, dtype=torch.int8)
    ws = torch.rand(cout, generator=g) * 1e-3
    bias = torch.randn(cout, generator=g)
    return [t.to(device) for t in (xq, w8, ws, bias)]


@pytest.mark.parametrize("n,h,w,cin,cout,k,dil", QCONV_EDGES)
def test_qconv_int8_matches_plain_bit_for_bit(cuda, n, h, w, cin, cout, k, dil):
    """The int32 accumulator equal to the float64 convolution's; the f32 and
    bf16 outputs equal to the plain epilogue's on that accumulator (the
    kernel rounds as the JAX graph does: no FMA, bf16 to nearest even)."""
    from dgvcc_tpu_torch.ops import qconv

    xq, w8, ws, bias = _qconv_case(cuda, n, h, w, cin, cout, k, n * h + w * cin + cout)
    s = 0.0123
    before = qconv.LAUNCHES
    acc = qconv.qconv_int8(xq, w8, None, s, None, dilation=dil, acc=True)
    ref = qconv.conv_acc_reference(xq, w8, dil)
    torch.cuda.synchronize()
    assert qconv.LAUNCHES == before + 1
    assert acc.dtype == torch.int32 and torch.equal(acc, ref)
    for dtype in (torch.float32, torch.bfloat16):
        for relu in (True, False):
            y = qconv.qconv_int8(xq, w8, ws, s, bias, relu=relu, dilation=dil, out_dtype=dtype)
            want = qconv.epilogue_reference(ref, ws, s, bias, relu, dtype)
            assert y.dtype == dtype and torch.equal(y, want)


@pytest.mark.parametrize("cin", [32, 64, 128])
@pytest.mark.parametrize("bn", [64, 128, 256])
def test_qconv_int8_tilings_match_plain_bit_for_bit(cuda, cin, bn):
    """Every kernel the int8 convolution is built for, reached through the
    shapes that pick it (Cin picks the K step kBK, Cout and the tile count
    BN, W the tile width, a 3x3 window with one K chunk and Cout <= 128 the
    halo schedule), bit for bit against the plain version: the per-tap
    schedule at BN 64, 128, 256 by kBK 32, 64, 128, at tile widths 1 to 64
    and dilation 2, and the halo schedule at BN 64, 128 by kBK 32, 64 with
    ragged Cout (Cout % 8 != 0 stores from the registers, Cout % 8 == 0
    through shared memory and TMA stores in bf16)."""
    from dgvcc_tpu_torch.ops import qconv

    cout = {64: 61, 128: 100, 256: 200}[bn]
    bk = {32: 32, 64: 64, 128: 128}[cin]
    # BN 256 needs between half a wave and a wave of 128-pixel tiles
    tiles = 3 * torch.cuda.get_device_properties(0).multi_processor_count // 4
    # (N, H, W, k, dilation, TW): TW 32 and 16 at `tiles` tiles, 64 at about
    # as many (1x1: the per-tap schedule), 1 at two tiles
    for n, h, w, k, dil, tw in ((1, 4 * tiles, 20, 3, 1, 32), (1, 8 * tiles, 13, 3, 2, 16),
                                (1, tiles, 100, 1, 1, 64), (2, 23, 1, 3, 1, 1)):
        xq, w8, ws, bias = _qconv_case(cuda, n, h, w, cin, cout, k, cin + bn + w)
        got = qconv.plan(xq.shape, w8.shape, dil)
        assert (got["schedule"], got["bk"], got["tw"]) == ("per_tap", bk, tw), got
        assert tw == 1 or got["bn"] == bn, got
        ref = qconv.conv_acc_reference(xq, w8, dil)
        acc = qconv.qconv_int8(xq, w8, None, 0.0123, None, dilation=dil, acc=True)
        y = qconv.qconv_int8(xq, w8, ws, 0.0123, bias, dilation=dil)
        torch.cuda.synchronize()
        assert torch.equal(acc, ref), (h, w, k, dil)
        assert torch.equal(y, qconv.epilogue_reference(ref, ws, 0.0123, bias, True,
                                                       torch.bfloat16)), (h, w, k, dil)
    if bn == 256:
        return
    # one BN tile, ragged, at TW 64: the halo schedule where its ring fits
    # (not at kBK 128; not at dilation 2 with BN 128 and kBK 64)
    for cout, dil in ((bn - 3, 1), (bn - 3, 2), (bn - 8, 1), (bn - 8, 2)):
        xq, w8, ws, bias = _qconv_case(cuda, 2, 9, 150, cin, cout, 3, cin + bn + cout + dil)
        got = qconv.plan(xq.shape, w8.shape, dil)
        assert got["bn"] == bn and (got["schedule"] == "halo") == (
            cin < 128 and (dil == 1 or cin * bn < 64 * 128)), got
        ref = qconv.conv_acc_reference(xq, w8, dil)
        acc = qconv.qconv_int8(xq, w8, None, 0.0123, None, dilation=dil, acc=True)
        for dtype in (torch.float32, torch.bfloat16):
            y = qconv.qconv_int8(xq, w8, ws, 0.0123, bias, relu=False, dilation=dil,
                                 out_dtype=dtype)
            torch.cuda.synchronize()
            assert torch.equal(y, qconv.epilogue_reference(ref, ws, 0.0123, bias, False,
                                                           dtype)), (cout, dil, dtype)
        assert torch.equal(acc, ref), (cout, dil)


def test_qconv_int8_plans_the_halo_schedule_for_final_full_size_sites(cuda):
    """The 64-channel sites at 768x1024 and 384x512 (and enc1/conv0, Cin 3
    padded to 16) take the halo schedule; the deep sites the per-tap one."""
    from dgvcc_tpu_torch.ops import qconv

    for cin, cout in ((3, 64), (64, 64), (64, 128)):
        assert qconv.plan((4, 768, 1024, cin), (cout, 3, 3, cin))["schedule"] == "halo"
    assert qconv.plan((4, 96, 128, 1024), (512, 3, 3, 1024))["schedule"] == "per_tap"


# CCTrans's 14 strided int8 sites at alt_gvt_large's widths, B=8, 768x1024
# (under min_ch=128): name -> (x shape, Cout, window = stride)
QCONV_STRIDED_SITES = {"b0_1_sr": ((8, 192, 256, 128), 128, 8), "pe1": ((8, 192, 256, 128), 256, 2),
                       "b1_1_sr": ((8, 96, 128, 256), 256, 4), "pe2": ((8, 96, 128, 256), 512, 2),
                       "pe3": ((8, 48, 64, 512), 1024, 2),
                       **{f"b2_{i}_sr": ((8, 48, 64, 512), 512, 2) for i in range(1, 18, 2)}}
# strided edges: H and W the stride does not divide (SAME pads low and
# high), Cin 16 and 67 (padded to 80), Cout 8 and 300, N = 3, tile widths
# from 4 to 64 at stride 8 to 2, and a 3x3 window at stride 2
# (n, h, w, cin, cout, k, stride)
QCONV_STRIDED_EDGES = [(3, 13, 11, 16, 8, 2, 2), (1, 37, 29, 67, 300, 4, 4),
                       (3, 21, 45, 16, 300, 8, 8), (2, 9, 70, 67, 8, 2, 2),
                       (1, 100, 67, 67, 8, 8, 8), (3, 30, 250, 16, 300, 4, 4),
                       (2, 15, 17, 16, 8, 3, 2)]


def _qconv_strided_check(xq, w8, ws, bias, stride):
    from dgvcc_tpu_torch.ops import qconv

    before = qconv.LAUNCHES
    acc = qconv.qconv_int8(xq, w8, None, 0.0123, None, acc=True, stride=stride)
    ref = qconv.conv_acc_reference(xq, w8, 1, stride)
    torch.cuda.synchronize()
    assert qconv.LAUNCHES == before + 1
    assert acc.shape == ref.shape and torch.equal(acc, ref)
    for dtype in (torch.float32, torch.bfloat16):
        y = qconv.qconv_int8(xq, w8, ws, 0.0123, bias, relu=False, out_dtype=dtype,
                             stride=stride)
        assert torch.equal(y, qconv.epilogue_reference(ref, ws, 0.0123, bias, False, dtype))


@pytest.mark.parametrize("name", sorted(QCONV_STRIDED_SITES))
def test_qconv_int8_strided_sites_match_plain_bit_for_bit(cuda, name):
    """CCTrans's patch embeddings and GSA's sr convolutions at full width:
    the per-tap schedule with a TMA box at the stride (element strides)."""
    from dgvcc_tpu_torch.ops import qconv

    (n, h, w, cin), cout, k = QCONV_STRIDED_SITES[name]
    xq, w8, ws, bias = _qconv_case(cuda, n, h, w, cin, cout, k, h + cin + cout + k)
    got = qconv.plan(xq.shape, w8.shape, stride=k)
    assert got["schedule"] == "per_tap" and got["tw"] * k <= 256, got
    _qconv_strided_check(xq, w8, ws, bias, k)


@pytest.mark.parametrize("n,h,w,cin,cout,k,stride", QCONV_STRIDED_EDGES)
def test_qconv_int8_strided_edges_match_plain_bit_for_bit(cuda, n, h, w, cin, cout, k, stride):
    from dgvcc_tpu_torch.ops import qconv

    xq, w8, ws, bias = _qconv_case(cuda, n, h, w, cin, cout, k, n + h * w + cin + cout)
    assert qconv.plan(xq.shape, w8.shape, stride=stride)["schedule"] == "per_tap"
    _qconv_strided_check(xq, w8, ws, bias, stride)


def test_qconv_int8_rejects_what_it_cannot_take(cuda):
    from dgvcc_tpu_torch.ops import qconv

    xq, w8, ws, bias = _qconv_case(cuda, 1, 8, 8, 16, 8, 3, 0)
    with pytest.raises(TypeError):
        qconv.qconv_int8(xq.float(), w8, ws, 0.1, bias)
    with pytest.raises(ValueError):
        qconv.qconv_int8(xq, w8[:, :2], ws, 0.1, bias)  # an even window
    with pytest.raises(ValueError):  # an even window at another stride than its own
        qconv.qconv_int8(xq, w8[:, :2, :2], ws, 0.1, bias, stride=4)
    with pytest.raises(ValueError):  # TMA's element strides stop at 8
        qconv.qconv_int8(xq, w8[:, :1, :1], ws, 0.1, bias, stride=9)
    with pytest.raises(ValueError):
        qconv.qconv_int8(xq, w8.cpu(), ws, 0.1, bias)
