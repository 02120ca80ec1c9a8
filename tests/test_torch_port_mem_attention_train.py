"""The port's two-view training attention
(dgvcc_tpu_torch.ops.mem_attention_train) on the CPU, where it takes its
plain version, against the JAX op: the Pallas kernel in interpret mode
(tile 32) and the JAX einsum twin. The inputs are those of
tests/test_mem_attention_train.py (seeded numpy, B=2, P=70 (not a tile
multiple), K=16, S=32) and so are the tolerances: forward 1e-5; float32
gradients of the asymmetric objective rtol 2e-4 / atol 2e-5; bfloat16
gradients 0.05 / 0.02 with dM to 0.02 in relative norm (dM lands in bf16,
so near-zero entries are pure rounding)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgvcc_tpu.ops.mem_attention_train import memory_attention_train as jax_train
from dgvcc_tpu.ops.mem_attention_train import memory_attention_train_reference as jax_ref
from dgvcc_tpu_torch.ops import mem_attention_train as mt

GOLDENS = {"pallas_interpret": lambda a, b, m: jax_train(a, b, m, tile=32, interpret=True),
           "jax_reference": jax_ref}


def _toy():
    rng = np.random.default_rng(0)
    b, p, k, s = 2, 70, 16, 32
    y1 = rng.normal(size=(b, p, k)).astype(np.float32)
    y2 = rng.normal(size=(b, p, k)).astype(np.float32)
    mem = (rng.normal(size=(k, s)) * 0.5).astype(np.float32)
    return y1, y2, mem


def _asymmetric(xp):
    """sum(o1 w1) + 0.5 sum(o2 w2) + 10 con: catches view sign errors and
    the softmax-VJP coupling (tests/test_mem_attention_train.py:41-50)."""
    def f(o1, o2, con):
        w1 = xp.cos(xp.arange(o1.size if xp is jnp else o1.numel(), dtype=xp.float32))
        w2 = xp.sin(xp.arange(o2.size if xp is jnp else o2.numel(), dtype=xp.float32))
        return (xp.sum(o1 * w1.reshape(o1.shape)) + 0.5 * xp.sum(o2 * w2.reshape(o2.shape))
                + 10.0 * con)
    return f


def _non_cancelling(xp):
    """The bf16 objective: the two views' dM terms do not cancel into
    bf16 noise (tests/test_mem_attention_train.py:70-79)."""
    def f(o1, o2, con):
        if xp is jnp:
            return jnp.sum(o1.astype(jnp.float32)) + 0.5 * jnp.sum(o2.astype(jnp.float32)) + 5.0 * con
        return o1.float().sum() + 0.5 * o2.float().sum() + 5.0 * con
    return f


def _port_grads(objective, arrays, dtype):
    ts = [torch.from_numpy(a).to(dtype).requires_grad_() for a in arrays]
    outs = mt.memory_attention_train(*ts)
    return torch.autograd.grad(objective(*outs), ts)


@pytest.mark.parametrize("golden", sorted(GOLDENS))
def test_forward_matches_jax(golden):
    y1, y2, mem = _toy()
    want = GOLDENS[golden](jnp.asarray(y1), jnp.asarray(y2), jnp.asarray(mem))
    got = mt.memory_attention_train(*(torch.from_numpy(a) for a in (y1, y2, mem)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("golden", sorted(GOLDENS))
def test_f32_gradients_match_jax(golden):
    arrays = _toy()
    fn = GOLDENS[golden]
    want = jax.grad(lambda a, b, m: _asymmetric(jnp)(*fn(a, b, m)), argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in arrays))
    got = _port_grads(_asymmetric(torch), arrays, torch.float32)
    for name, g, w in zip(("dy1", "dy2", "dmem"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4, atol=2e-5,
                                   err_msg=name)


@pytest.mark.parametrize("golden", sorted(GOLDENS))
def test_bf16_gradients_match_jax(golden):
    arrays = _toy()
    fn = GOLDENS[golden]
    want = jax.grad(lambda a, b, m: _non_cancelling(jnp)(*fn(a, b, m)), argnums=(0, 1, 2))(
        *(jnp.asarray(a, jnp.bfloat16) for a in arrays))
    got = _port_grads(_non_cancelling(torch), arrays, torch.bfloat16)
    assert all(g.dtype == torch.bfloat16 for g in got)
    for name, g, w in zip(("dy1", "dy2"), got[:2], want[:2]):
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32),
                                   rtol=0.05, atol=0.02, err_msg=name)
    a, b = got[2].float().numpy(), np.asarray(want[2], np.float32)
    assert np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-9) < 0.02


def test_plain_version_gradcheck_f64():
    g = torch.Generator().manual_seed(0)
    args = [torch.randn(*shape, generator=g, dtype=torch.float64, requires_grad=True)
            for shape in ((1, 5, 4), (1, 5, 4), (4, 6))]
    assert torch.autograd.gradcheck(mt.memory_attention_train_reference, args)


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    y1, y2, mem = (torch.from_numpy(a) for a in _toy())
    before = (mt.FWD_LAUNCHES, mt.BWD_LAUNCHES)
    got = mt.memory_attention_train(y1, y2, mem)
    want = mt.memory_attention_train_reference(y1, y2, mem)
    assert (mt.FWD_LAUNCHES, mt.BWD_LAUNCHES) == before
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError, match="do not form"):
        mt.memory_attention_train(y1, y2[:, :5], mem)


# ---- D = <dp, p>_S from what the forward saves (lse, q) and its outputs

def _jax_p_dp(y1, y2, mem, do1, do2, g):
    """p_i of the JAX package's reference (its softmax) and dp_i, the
    cotangent that reaches p_i through the rest of the reference (the cast
    and back-projection, and the consistency loss), by jax.vjp."""
    k = y1.shape[-1]

    def probs(y):
        l = jnp.einsum("bpk,ks->bps", y, mem, preferred_element_type=jnp.float32) / np.sqrt(k)
        return jax.nn.softmax(l, axis=-1)

    def tail(p1, p2):
        def out(p, y):
            return jnp.einsum("bps,sk->bpk", p.astype(mem.dtype), mem.T,
                              preferred_element_type=jnp.float32).astype(y.dtype)
        return out(p1, y1), out(p2, y2), jnp.mean((p1 - p2) ** 2)

    p1, p2 = probs(y1), probs(y2)
    _, vjp = jax.vjp(tail, p1, p2)
    dp1, dp2 = vjp((do1, do2, jnp.asarray(g, jnp.float32)))
    return (p1, p2), (dp1, dp2)


def _dsum_case(shape, loss_only, seed):
    b, p, k, s = shape
    rng = np.random.default_rng(seed)
    y1, y2 = (rng.normal(size=(b, p, k)).astype(np.float32) for _ in range(2))
    mem = (rng.normal(size=(k, s)) * 0.5).astype(np.float32)
    if loss_only:  # the gradients of loss_con alone, scaled by rows x S
        do1 = do2 = np.zeros((b, p, k), np.float32)
        g = float(b * p * s)
    else:
        do1, do2 = (rng.normal(size=(b, p, k)).astype(np.float32) for _ in range(2))
        g = 3.0
    return y1, y2, mem, do1, do2, g


DSUM_SHAPES = {"toy": (2, 70, 16, 32), "tail": (1, 6400 + 37, 16, 32)}


@pytest.mark.parametrize("shape", sorted(DSUM_SHAPES))
def test_saved_reference_matches_jax_softmax(shape):
    """lse and q of the plain version against the JAX reference's p:
    float32 at 1e-5 relative."""
    y1, y2, mem, *_ = _dsum_case(DSUM_SHAPES[shape], False, 1)
    (p1, p2), _ = _jax_p_dp(*(jnp.asarray(a) for a in (y1, y2, mem, y1, y2)), 0.0)
    lse, q = mt.saved_reference(*(torch.from_numpy(a) for a in (y1, y2, mem)))
    k = y1.shape[-1]
    for i, y in enumerate((y1, y2)):
        l = jnp.einsum("bpk,ks->bps", y, mem) / np.sqrt(k)
        want = np.asarray(jax.nn.logsumexp(l, axis=-1)).reshape(-1)
        np.testing.assert_allclose(lse[i].numpy(), want, rtol=1e-5, atol=1e-5)
    p1, p2 = (np.asarray(a, np.float64).reshape(-1, mem.shape[1]) for a in (p1, p2))
    for got, want in zip(q, ((p1 * p1).sum(-1), (p2 * p2).sum(-1), (p1 * p2).sum(-1))):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


# bf16: out and dout are bf16, and the JAX reference rounds dp to bf16 (the
# cotangent of its cast of p), each about 2e-3 relative: D against
# <dp, p>_S to 1e-2 of max |D| (3.7e-3 measured at the toy shape)
DSUM_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("loss_only", [False, True], ids=["mixed", "loss_only"])
@pytest.mark.parametrize("shape", sorted(DSUM_SHAPES))
def test_dsum_rule_matches_jax_dp_dot_p(shape, loss_only, dtype):
    """The backward's D rule (plain version) against D = <dp, p>_S with p
    and dp from the JAX reference on the same numpy-seeded inputs: under a
    random cotangent with g = 3, under the consistency loss alone (dout =
    0), and on a tail of P = 6400 + 37 rows. Relative to max |D|."""
    y1, y2, mem, do1, do2, g = _dsum_case(DSUM_SHAPES[shape], loss_only, 2)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    (p1, p2), (dp1, dp2) = _jax_p_dp(*(jnp.asarray(a, jdt) for a in (y1, y2, mem, do1, do2)),
                                     g)
    want = np.stack([np.sum(np.asarray(dp, np.float64) * np.asarray(p, np.float64), -1)
                     .reshape(-1) for dp, p in ((dp1, p1), (dp2, p2))])
    t1, t2, tm, td1, td2 = (torch.from_numpy(a).to(dtype) for a in (y1, y2, mem, do1, do2))
    out1, out2, _ = mt.memory_attention_train_reference(t1, t2, tm)
    _, q = mt.saved_reference(t1, t2, tm)
    got = mt.dsum_reference(td1, td2, out1, out2, q, torch.tensor(g), mem.shape[1])
    assert got.shape == (2, y1.shape[0] * y1.shape[1]) and got.dtype == torch.float32
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got.double().numpy(), want, rtol=0,
                               atol=DSUM_TOL[dtype] * scale)


# ---- the bf16 forward kernel's one-sweep algorithm (online_forward_reference)

ONLINE_SHAPES = {"k16_s32": (2, 70, 16, 32), "k16_s1001": (2, 70, 16, 1001),
                 "k256_s32": (2, 70, 256, 32), "k256_s1001": (2, 70, 256, 1001)}
ONLINE_EPS = (1.0, 0.1, 0.01, 0.001)


def _near_views(shape, eps, seed=4):
    """y2 = y1 + eps N(0, 1): as eps falls the views agree and loss_con
    falls below q by up to 1e-9 (eps = 0.001), where summing it from q
    cancels."""
    b, p, k, s = shape
    rng = np.random.default_rng(seed)
    y1 = rng.normal(size=(b, p, k)).astype(np.float32)
    y2 = (y1 + eps * rng.normal(size=y1.shape)).astype(np.float32)
    mem = (rng.normal(size=(k, s)) * 0.5).astype(np.float32)
    return y1, y2, mem


@pytest.mark.parametrize("eps", ONLINE_EPS)
@pytest.mark.parametrize("shape", sorted(ONLINE_SHAPES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("golden", sorted(GOLDENS))
def test_online_forward_matches_jax(golden, dtype, shape, eps):
    """The kernel's one sweep against the JAX op on the same numpy inputs
    (P = 70: a row tail of the Pallas tile 32; S = 1001: a chunk tail):
    loss_con to 1e-3 relative down to eps = 0.001; out to 1e-5 in f32 and to
    1e-2 in relative norm in bf16 (the sweep rounds the unnormalised e to
    bf16, the JAX op the normalised p)."""
    arrays = _near_views(ONLINE_SHAPES[shape], eps)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = GOLDENS[golden](*(jnp.asarray(a, jdt) for a in arrays))
    got = mt.online_forward_reference(*(torch.from_numpy(a).to(dtype) for a in arrays))
    w_con = float(want[2])
    assert w_con > 0 and abs(got[2].item() - w_con) <= 1e-3 * w_con
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == dtype and g.shape == arrays[0].shape
        g, w = g.float().numpy(), np.asarray(w, np.float32)
        if dtype == torch.float32:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
        else:
            assert np.linalg.norm(g - w) / np.linalg.norm(w) <= 1e-2


@pytest.mark.parametrize("eps", ONLINE_EPS)
@pytest.mark.parametrize("shape", sorted(ONLINE_SHAPES))
def test_online_lse_and_q_match_jax_softmax(shape, eps):
    """lse and q of the one sweep against the JAX reference's logits and p
    (float64 sums of its float32 p): float32 at 1e-5 relative, also where
    the views agree."""
    y1, y2, mem = _near_views(ONLINE_SHAPES[shape], eps)
    _, _, _, lse, q = mt.online_forward_reference(*(torch.from_numpy(a) for a in (y1, y2, mem)))
    (p1, p2), _ = _jax_p_dp(*(jnp.asarray(a) for a in (y1, y2, mem, y1, y2)), 0.0)
    k = y1.shape[-1]
    for i, y in enumerate((y1, y2)):
        l = jnp.einsum("bpk,ks->bps", y, mem) / np.sqrt(k)
        want = np.asarray(jax.nn.logsumexp(l, axis=-1)).reshape(-1)
        np.testing.assert_allclose(lse[i].numpy(), want, rtol=1e-5, atol=1e-5)
    p1, p2 = (np.asarray(a, np.float64).reshape(-1, mem.shape[1]) for a in (p1, p2))
    for got, want in zip(q, ((p1 * p1).sum(-1), (p2 * p2).sum(-1), (p1 * p2).sum(-1))):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


def _loss_from_q_sums(y1, y2, mem, chunk=64):
    """The one sweep with the loss term formed from f32 running sums as
    q11 + q22 - 2 q12 (each rescaled by the running maxima), as a kernel
    without the cancellation-free recurrence would form it."""
    k, s = y1.shape[-1], mem.shape[1]
    logits = [torch.matmul(y.reshape(-1, k), mem) / np.sqrt(k) for y in (y1, y2)]
    rows = logits[0].shape[0]
    m = [torch.full((rows, 1), -np.inf) for _ in range(2)]
    l = [torch.zeros(rows, 1) for _ in range(2)]
    q11, q22, q12 = (torch.zeros(rows, 1) for _ in range(3))
    for s0 in range(0, s, chunk):
        e, a = [], []
        for i in range(2):
            lc = logits[i][:, s0:s0 + chunk]
            m_new = torch.maximum(m[i], lc.amax(-1, keepdim=True))
            a.append(torch.exp(m[i] - m_new))
            e.append(torch.exp(lc - m_new))
            l[i], m[i] = a[i] * l[i] + e[i].sum(-1, keepdim=True), m_new
        q11 = q11 * a[0] * a[0] + (e[0] * e[0]).sum(-1, keepdim=True)
        q22 = q22 * a[1] * a[1] + (e[1] * e[1]).sum(-1, keepdim=True)
        q12 = q12 * a[0] * a[1] + (e[0] * e[1]).sum(-1, keepdim=True)
    terms = q11 / l[0] ** 2 + q22 / l[1] ** 2 - 2 * q12 / (l[0] * l[1])
    return (terms.sum() / (rows * s)).item()


def test_loss_from_f32_q_sums_cancels_where_views_agree():
    """Why the kernel carries D = <u1 - u2, u1 - u2> by its recurrence: at
    eps = 0.001 the loss term is about 1e-9 of q, and q11 + q22 - 2 q12 from
    f32 sums misses loss_con by more than its 1e-3 tolerance, where the
    recurrence holds it."""
    arrays = _near_views(ONLINE_SHAPES["k256_s1001"], 0.001)
    t = [torch.from_numpy(a) for a in arrays]
    truth = mt.memory_attention_train_reference(*(a.double() for a in t))[2].item()
    from_q = _loss_from_q_sums(*t)
    recurrence = mt.online_forward_reference(*t)[2].item()
    assert abs(from_q - truth) > 1e-3 * truth
    assert abs(recurrence - truth) <= 1e-5 * truth
