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
its plain version and the numpy golden (f32, other summation order).
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
