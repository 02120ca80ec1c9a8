#!/usr/bin/env python3
"""On-card smoke test of the PyTorch / CUDA port (dgvcc_tpu_torch).

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. build every CUDA kernel of the port from the checkout's sources
   (nvcc, sm_90a, into build/torch_ext/); the bf16 builds of the serving
   kernel, of the training forward and of the training backward's rows
   and cols kernels must hold wgmma fed by TMA (SASS, body by body: HGMMA
   and UTMALDG, no HMMA) with no serialised wgmma (ptxas C7512, C7514)
   and no spill at K=256;
2. hold each kernel against its plain PyTorch version on the card at the
   shapes its path gives it: the serving kernel at K=256, S=1024,
   P=192*256 per 768x1024 frame, B=4, and in bf16 at its edges (rows
   below one 128-row tile, the validation shape B=1, S below one chunk,
   S % 8 != 0, every width) and bit for bit across two calls; the
   two-view training kernels
   (forward and backward) at B=16, P=80*80 per 320x320 crop, both views,
   under a mixed objective and under the consistency loss alone;
   each in bf16 and f32, plus an awkward size; the forward also with views
   that agree to 0.1, 0.01 and 0.001 (loss_con, q, two calls bit for bit);
3. serve full-width DGModel ``final`` (VGG16-BN, 1024x256 bank, seeded
   random weights, bf16, fused_mem=True) through VideoCounter: 768x1024
   frames by count_frames (B=4) and stream (4 batches of 16), a
   1080x1920 batch through bucket padding and through 2x3 tiles of 768.
   Every path must launch the kernel and agree with the same counter on
   the einsum path (fused_mem=False). Then the command line,
   ``python -m dgvcc_tpu_torch --task serve`` with configs/sta_final.yml,
   counts four JPEG frames;
   The density-map kernel (#4) against its plain version at 768x1024 with
   1024 points, 1080x1920 with 4000 (points on every border, outside the
   image, in (-1, 0), and masked pad rows), no points, and 17x23;
4. time the serving path (frames/s at B=1, 4, 16; stream) and the kernel
   alone against its plain version and one library call (SDPA); the
   density-map kernel against its plain version and cuBLAS A . B^T in
   interleaved turns (medians);
5. train full-width DGModel ``final`` as configs/sta_final.yml says (bf16
   compute, f32 AdamW master weights, the OneCycle lr of epoch 0) on a
   synthetic two-view batch of 16 crops of 320x320: step 1 on the kernel
   path must agree with step 1 on the einsum path (fused_mem_train=False)
   from the same weights, ten more steps on the repeated batch must keep
   the loss finite and bring it down, and each step must launch the
   forward and the backward kernel once; then ms/step and peak memory of
   both paths, and the training kernels' times against their bounds and
   their plain version, and per launch by kernel name;
6. from files to a trained model: write a dataset in the canonical layout
   (40 JPEGs of 768x1024 with 50 to 600 head points each), make its
   density maps with ``python -m dgvcc_tpu_torch.data.dmap_cli`` (one
   kernel #4 launch per image; three maps against the numpy golden), then
   ``DGTrainer.train_and_test`` with configs/sta_final.yml pointed there
   for 2 epochs: kernels #2/#3 once per train step, kernel #1 in every
   validation and test forward and no einsum-path bank forward, finite
   losses and MAE, the JAX trainer's log.txt lines, ``last`` / ``best_*``
   checkpoints that VideoCounter strict-loads, and ``--task test`` from the
   best checkpoint on the command line printing the in-process MAE / MSE.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. Without CUDA, or outside
a checkout of the repo, the script exits non-zero and prints no result.
"""

import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, f32 CUDA
# cores, HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

K, S = 256, 1024                    # bank width and prototypes of `final`
FRAME = (768, 1024)                 # serving frame; P = 192 * 256 = 49152
P = (FRAME[0] // 4) * (FRAME[1] // 4)
TOL_F32 = 1e-4                      # f32 kernel vs plain (summation order)
TOL_BF16 = 2e-2                     # bf16 output vs f32 plain (one bf16 rounding)
TOL_COUNTS = 2e-2                   # fused vs einsum serving counts, relative:
                                    # the einsum path rounds the attention to bf16

TRAIN_B, TRAIN_CROP = 16, 320       # sta_final.yml: batch 16 of 320x320 crops
TRAIN_P = (TRAIN_CROP // 4) ** 2    # 6400 rows per view and crop at stride 4
# training kernels vs their plain version (TF32 off for the plain one):
TOL_TRAIN_F32 = 1e-4                # f32 forward (loss_con relative): other order
                                    # of summation
TOL_TRAIN_F32_GRAD = 1e-3           # f32 gradients: longer sums, other order
TOL_TRAIN_BF16 = 2e-2               # bf16 outputs: one bf16 rounding
TOL_TRAIN_CON = 1e-3                # loss_con, relative: p is exact f32 in both
# q = (<p1,p1>, <p2,p2>, <p1,p2>)_S per row against saved_reference,
# relative: f32 sums in another order; the bf16 kernel's logits are f32
# sums of the bf16 products in the tensor cores' order and its exp2 is the
# SFU's (2 ulp), each about 1e-6 relative (4e-6 to 6e-6 measured)
TOL_TRAIN_Q = {torch.float32: 1e-5, torch.bfloat16: 1e-4}
NEAR_EPS = (0.1, 0.01, 0.001)       # y2 = y1 + eps N(0, 1): the views agree, so
                                    # loss_con falls to ~1e-9 of q
TOL_TRAIN_DY = (0.05, 0.02)         # bf16 dy rtol, atol and dM relative norm:
TOL_TRAIN_DM = 0.02                 # tests/test_mem_attention_train.py:86-94
TOL_TRAIN_BF16_NORM = 1e-2          # bf16 out and dy, relative norm: the kernel
                                    # rounds dl to bf16, the plain version does not
                                    # (about 1e-3); the elementwise limits above are
                                    # a third of a typical value at full width
TOL_TRAIN_LOSS = {torch.float32: 1e-4,   # gradients of loss_con alone, relative
                  torch.bfloat16: 1e-2}  # norm: f32 sums in another order; bf16
                                         # as TOL_TRAIN_BF16_NORM
# the train step, kernel path vs einsum path, step 1 from the same weights:
TOL_STEP_LOSS = 1e-2                # loss parts, relative: up to the bank the two
                                    # paths compute the same; its bf16 outputs may
                                    # round to neighbouring values
TOL_STEP_GRAD = 5e-2                # gradient relative norm: the two round the
                                    # attention's cotangents to bf16 at other places
                                    # (dp in the einsum path, dl in the kernel)
STEP_GRADS = ("mem", "dec1.0.conv.weight", "den_dec.0.conv.weight",
              "den_head.0.conv.weight")
# density-map kernel vs its plain version (A . B^T, TF32 off) and the numpy
# golden: f32; the kernel sums each pixel's covering points in point order
# (FMA), the product and the golden (float64, rounded once) in their own
TOL_DMAP = dict(atol=1e-5, rtol=1e-4)
DMAP_SHAPES = ((768, 1024, 1024), (1080, 1920, 4000), (768, 1024, 0), (17, 23, 40))
DMAP_TURNS = 5                      # kernel #4 and cuBLAS timed in turns
TOL_CLI_TEST = 1e-3                 # CLI --task test vs in-process test(), relative


def log(msg):
    print(f"[chip_smoke] {msg}", flush=True)


def fail(msg):
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters, warmup=2):
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_kernel(ma, b, p, dtype, tol, seed, k=K, s=S):
    """Kernel #1 against its f32 plain version on the same inputs; with
    two calls bit for bit in bf16 (no float atomics)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    y = torch.randn(b, p, k, generator=g, device="cuda").to(dtype)
    mem = torch.randn(k, s, generator=g, device="cuda").to(dtype)
    out = ma.memory_attention_fused(y, mem)
    again = ma.memory_attention_fused(y, mem)
    torch.cuda.synchronize()
    ref = ma.memory_attention_reference(y.float(), mem.float())
    err = (out.float() - ref).abs()
    max_abs = err.max().item()
    max_rel = (err / ref.abs().clamp_min(1e-3)).max().item()
    same = bool(torch.equal(out, again))
    ok = bool(torch.allclose(out.float(), ref, atol=tol, rtol=tol)) and same
    log(f"kernel {str(dtype):>14} B={b} P={p} K={k} S={s}: max_abs_err="
        f"{max_abs:.3e} max_rel_err(|ref|>=1e-3)={max_rel:.3e} tol={tol}, two calls "
        f"{'bit-identical' if same else 'DIFFER'} {'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"memory_attention_fused disagrees with its plain version or with "
             f"itself ({dtype}, B={b}, P={p}, K={k}, S={s})")
    return max_abs


# kernel #1's bf16 edges (B, P, K, S): rows below one 128-row tile, the
# validation shape (B=1), S below one 64-prototype chunk, S % 8 != 0 at
# K=256 (M padded for its tensor map), every width
EDGES_BF16 = ((1, 37, 256, 1024), (1, P, 256, 1024), (2, 300, 256, 40),
              (1, 1001, 256, 1001), (2, 333, 16, 200), (2, 333, 32, 200),
              (2, 333, 64, 200), (2, 333, 128, 200), (2, 333, 256, 200))
MMA_SYNC_BF16_ERR = 1.793e-3  # the earlier mma.sync kernel's, B=4 (PERF.md)


SASS_OPS = ("HGMMA", "UTMALDG", "UTMASTG", "HMMA")


def sass_counts(sass, pattern):
    """{function name: {op: count}} of the function bodies of ``cuobjdump
    -sass`` text whose (mangled) name matches the regular expression
    ``pattern``, counted body by body."""
    bodies = {}
    for f in re.split(r"\n\s*Function : ", sass)[1:]:
        name = f.splitlines()[0].strip()
        if re.search(pattern, name):
            bodies[name] = {op: len(re.findall(rf"\b{op}\b", f)) for op in SASS_OPS}
    return bodies


def wgmma_tma_faults(bodies, n_expected):
    """What in ``sass_counts`` shows a kernel off wgmma fed by TMA: a count
    of bodies other than ``n_expected``, a body without HGMMA or UTMALDG,
    or one with HMMA (mma.sync)."""
    faults = [] if len(bodies) == n_expected else [
        f"{len(bodies)} function bodies, expected {n_expected}"]
    for name, c in bodies.items():
        if not c["HGMMA"] or not c["UTMALDG"] or c["HMMA"]:
            faults.append(f"{name}: {c}")
    return faults


def check_sass(lib, pattern, n_expected, what):
    """The bf16 kernels of ``lib`` whose names match ``pattern`` run on
    wgmma fed by TMA: every one of their SASS bodies holds HGMMA and
    UTMALDG and no HMMA. Returns the counts summed over those bodies."""
    import shutil

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        fail(f"cuobjdump not found: the SASS of {what} cannot be checked")
    sass = subprocess.run([tool, "-sass", lib], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    bodies = sass_counts(sass, pattern)
    counts = {op: sum(c[op] for c in bodies.values()) for op in SASS_OPS}
    log(f"SASS of {os.path.basename(lib)}, {len(bodies)} bf16 kernels of {what}: {counts}")
    faults = wgmma_tma_faults(bodies, n_expected)
    if faults:
        fail(f"{what}: bf16 build does not run on wgmma fed by TMA: {'; '.join(faults)}")
    return counts


def train_objective(dtype):
    """f32: the asymmetric objective of tests/test_mem_attention_train.py
    (catches view sign errors); bf16: its non-cancelling one, so the two
    views' dM terms do not cancel into bf16 noise. At these shapes its loss
    term is about 1e-11 of dp, so check_train_kernels also holds the
    gradients of loss_con alone."""
    def f(o1, o2, con):
        if dtype == torch.float32:
            w = torch.arange(o1.numel(), dtype=torch.float32, device=o1.device)
            return ((o1 * torch.cos(w).reshape(o1.shape)).sum()
                    + 0.5 * (o2 * torch.sin(w).reshape(o2.shape)).sum() + 10.0 * con)
        return o1.float().sum() + 0.5 * o2.float().sum() + 5.0 * con
    return f


def rel_norm(a, r):
    return ((a - r).norm() / r.norm()).item()


def check_train_kernels(mt, b, p, dtype, seed):
    """Kernels #2 and #3 through memory_attention_train (forward, and the
    gradients by torch.autograd.grad) against the plain version on the
    same inputs. Two objectives: train_objective, and loss_con x rows x S
    alone (cotangent g = rows x S, so dp = +-2 (p1 - p2)): dy1, dy2 and dM
    of the second come from the consistency branch only."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    y1, y2 = (torch.randn(b, p, K, generator=g, device="cuda").to(dtype) for _ in range(2))
    mem = torch.randn(K, S, generator=g, device="cuda").to(dtype)
    obj = train_objective(dtype)
    res = {}
    for name, fn in (("kernel", mt.memory_attention_train),
                     ("plain", mt.memory_attention_train_reference)):
        leaves = [t.clone().requires_grad_() for t in (y1, y2, mem)]
        outs = fn(*leaves)
        grads = torch.autograd.grad(obj(*outs), leaves, retain_graph=True)
        con_grads = torch.autograd.grad(outs[2] * float(b * p * S), leaves)
        res[name] = [t.detach().float() for t in outs] + [t.float() for t in grads + con_grads]
        del outs, grads, con_grads, leaves
    torch.cuda.synchronize()
    (o1, o2, con, dy1, dy2, dm, cy1, cy2, cm) = res["kernel"]
    (r1, r2, rcon, ry1, ry2, rdm, rc1, rc2, rcm) = res["plain"]
    err = dict(out=max((o1 - r1).abs().max().item(), (o2 - r2).abs().max().item()),
               out_rel=max(rel_norm(o1, r1), rel_norm(o2, r2)),
               con_rel=abs(con.item() - rcon.item()) / abs(rcon.item()),
               dy=max((dy1 - ry1).abs().max().item(), (dy2 - ry2).abs().max().item()),
               dy_rel=max(rel_norm(dy1, ry1), rel_norm(dy2, ry2)),
               dm_rel=rel_norm(dm, rdm),
               con_dy_rel=max(rel_norm(cy1, rc1), rel_norm(cy2, rc2)),
               con_dm_rel=rel_norm(cm, rcm))
    loss_branch_ok = max(err["con_dy_rel"], err["con_dm_rel"]) <= TOL_TRAIN_LOSS[dtype]
    if dtype == torch.float32:
        ok = (all(torch.allclose(a, r, atol=TOL_TRAIN_F32, rtol=TOL_TRAIN_F32)
                  for a, r in ((o1, r1), (o2, r2)))
              and err["con_rel"] <= TOL_TRAIN_F32
              and all(torch.allclose(a, r, atol=TOL_TRAIN_F32_GRAD, rtol=TOL_TRAIN_F32_GRAD)
                      for a, r in ((dy1, ry1), (dy2, ry2), (dm, rdm)))
              and loss_branch_ok)
    else:
        rtol, atol = TOL_TRAIN_DY
        ok = (all(torch.allclose(a, r, atol=TOL_TRAIN_BF16, rtol=TOL_TRAIN_BF16)
                  for a, r in ((o1, r1), (o2, r2)))
              and err["out_rel"] <= TOL_TRAIN_BF16_NORM
              and err["con_rel"] <= TOL_TRAIN_CON
              and all(torch.allclose(a, r, atol=atol, rtol=rtol)
                      for a, r in ((dy1, ry1), (dy2, ry2)))
              and err["dy_rel"] <= TOL_TRAIN_BF16_NORM
              and err["dm_rel"] < TOL_TRAIN_DM
              and loss_branch_ok)
    log(f"train kernels {str(dtype):>14} B={b} P={p} K={K} S={S}: out max_abs_err "
        f"{err['out']:.3e} rel_norm_err {err['out_rel']:.3e}, loss_con rel_err "
        f"{err['con_rel']:.3e}, dy max_abs_err {err['dy']:.3e} rel_norm_err "
        f"{err['dy_rel']:.3e}, dM rel_norm_err {err['dm_rel']:.3e}; loss_con alone: "
        f"dy rel_norm_err {err['con_dy_rel']:.3e}, dM rel_norm_err "
        f"{err['con_dm_rel']:.3e} (tol {TOL_TRAIN_LOSS[dtype]}) "
        f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"memory_attention_train disagrees with its plain version "
             f"({dtype}, B={b}, P={p})")
    return err


def check_train_forward_near(mt, dtype, eps, seed):
    """Kernel #2 at the training shape with views that agree (y2 = y1 + eps
    N(0, 1)), where the loss term is a small difference of the q sums:
    loss_con against the plain version, lse and q against saved_reference,
    two calls bit for bit. Returns loss_con's and q's relative errors."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    y1 = torch.randn(TRAIN_B, TRAIN_P, K, generator=g, device="cuda")
    y2 = (y1 + eps * torch.randn(TRAIN_B, TRAIN_P, K, generator=g, device="cuda")).to(dtype)
    y1 = y1.to(dtype)
    mem = torch.randn(K, S, generator=g, device="cuda").to(dtype)
    got = mt.memory_attention_train_forward(y1, y2, mem)
    again = mt.memory_attention_train_forward(y1, y2, mem)
    torch.cuda.synchronize()
    r1, r2, rcon = mt.memory_attention_train_reference(y1, y2, mem)
    rlse, rq = mt.saved_reference(y1, y2, mem)
    con_rel = abs(got[2].item() - rcon.item()) / rcon.item()
    q_rel = ((got[4] - rq).abs() / rq.abs()).max().item()
    lse_err = (got[3] - rlse).abs().max().item()
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    tol_con = TOL_TRAIN_CON if dtype == torch.bfloat16 else TOL_TRAIN_F32
    tol_out = TOL_TRAIN_BF16 if dtype == torch.bfloat16 else TOL_TRAIN_F32
    ok = (same and con_rel <= tol_con and q_rel <= TOL_TRAIN_Q[dtype]
          and lse_err <= TOL_TRAIN_F32
          and all(torch.allclose(a.float(), r.float(), atol=tol_out, rtol=tol_out)
                  for a, r in ((got[0], r1), (got[1], r2))))
    log(f"train fwd {str(dtype):>14} B={TRAIN_B} P={TRAIN_P} views eps={eps}: loss_con "
        f"{got[2].item():.4e} rel_err {con_rel:.3e} (tol {tol_con}), q max rel_err "
        f"{q_rel:.3e} (tol {TOL_TRAIN_Q[dtype]}), lse max_abs_err {lse_err:.3e}, two calls "
        f"{'bit-identical' if same else 'DIFFER'} {'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"memory_attention_train_forward disagrees with its plain version or with "
             f"itself where the views agree ({dtype}, eps={eps})")
    return con_rel, q_rel


def launch_times(fn, iters):
    """Device time of each kernel that ``fn`` launches, by kernel name:
    {name: (launches per call, ms per launch)} under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {e.key: (e.count / iters, getattr(e, "self_device_time_total", 0) / 1e3 / e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.count}


def bound(flops, nbytes, peak_flops):
    t_ops, t_bytes = 1e3 * flops / peak_flops, 1e3 * nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def synthetic_batch(seed):
    """Two views of 16 crops (the second a perturbed copy, as augmented
    views are), a density map of about 20 heads a crop (box-blurred points)
    and its foreground map at stride 16, NCHW on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    shape = (TRAIN_B, 3, TRAIN_CROP, TRAIN_CROP)
    img1 = torch.randn(shape, generator=g, device="cuda")
    img2 = img1 + 0.25 * torch.randn(shape, generator=g, device="cuda")
    heads = (torch.rand(TRAIN_B, 1, TRAIN_CROP, TRAIN_CROP, generator=g, device="cuda")
             < 2e-4).float()
    dmap = torch.nn.functional.avg_pool2d(heads, 9, stride=1, padding=4)
    bmap = (torch.nn.functional.avg_pool2d(dmap, 16) > 0).float()
    return {"img1": img1, "img2": img2, "dmap": dmap, "bmap": bmap}


def train_phase(mt, gpu):
    """Phase 5: the training main path. Returns the launch counts of its
    run and the training kernels' times."""
    import dgvcc_tpu_torch.losses  # noqa: F401
    import dgvcc_tpu_torch.models  # noqa: F401
    from dgvcc_tpu_torch.core.config import load_config
    from dgvcc_tpu_torch.core.registry import LOSSES, MODELS
    from dgvcc_tpu_torch.train.state import create_train_state
    from dgvcc_tpu_torch.train.steps import build_train_step

    cfg = load_config(os.path.join(ROOT, "configs", "sta_final.yml"))
    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32

    def build(fused_mem_train):
        model = MODELS.build(cfg.model["name"], dtype=dtype,
                             fused_mem_train=fused_mem_train, **cfg.model.get("params", {}))
        model.reset_parameters(torch.Generator().manual_seed(cfg.seed))
        state = create_train_state(model, cfg.optimizer, cfg.scheduler)
        loss = LOSSES.build(cfg.loss["name"], **cfg.loss.get("params", {}))
        return state, build_train_step(model, loss, cfg.mode, cfg.log_para)

    batch = synthetic_batch(1)
    gen = torch.Generator(device="cuda")

    def run(path):
        """One step on the repeated batch, with the same dropout draw."""
        gen.manual_seed(cfg.seed)
        return path[1](path[0], batch, gen, 0)[1]

    kern, plain = build(True), build(False)
    for (k1, v1), (k2, v2) in zip(kern[0].model.state_dict().items(),
                                  plain[0].model.state_dict().items()):
        if k1 != k2 or not torch.equal(v1, v2):
            fail(f"seeded weights differ between the two train states at {k1}")
    lr = kern[0].optimizer.param_groups[0]["lr"]
    log(f"train: DGModel final (sta_final.yml), {dtype}, AdamW lr {lr:.6g} "
        f"(OneCycle, epoch 0), batch {TRAIN_B}x2 views of {TRAIN_CROP}x{TRAIN_CROP}")

    # ---- the main path: step 1 of both paths, ten more on the kernel path
    mt.FWD_LAUNCHES = mt.BWD_LAUNCHES = 0
    m_kern = {k: v.item() for k, v in run(kern).items()}
    g_kern = {n: p.grad.detach().float().clone()
              for n, p in kern[0].model.named_parameters() if n in STEP_GRADS}
    m_plain = {k: v.item() for k, v in run(plain).items()}
    g_plain = {n: p.grad.detach().float().clone()
               for n, p in plain[0].model.named_parameters() if n in STEP_GRADS}
    for k in m_kern:
        a, b = m_kern[k], m_plain[k]
        rel = abs(a - b) / max(abs(b), 1e-12)
        log(f"train step 1 {k}: kernel path {a:.6g}, einsum path {b:.6g}, rel diff "
            f"{rel:.3e} (tol {TOL_STEP_LOSS})")
        if not (math.isfinite(a) and (rel <= TOL_STEP_LOSS or abs(a - b) <= 1e-12)):
            fail(f"train step 1: {k} of the kernel path disagrees with the einsum path")
    for n in STEP_GRADS:
        rel = ((g_kern[n] - g_plain[n]).norm() / g_plain[n].norm()).item()
        log(f"train step 1 grad {n}: rel norm diff {rel:.3e} (tol {TOL_STEP_GRAD})")
        if not rel <= TOL_STEP_GRAD:
            fail(f"train step 1: the gradient of {n} disagrees with the einsum path")
    losses = [m_kern["loss_total"]]
    for _ in range(10):
        losses.append(run(kern)["loss_total"].item())
    launches = (mt.FWD_LAUNCHES, mt.BWD_LAUNCHES)
    log(f"train kernel path, 11 steps: loss_total {[round(x, 4) for x in losses]}; "
        f"memory_attention_train forward launched {launches[0]}x, backward "
        f"{launches[1]}x")
    if not all(math.isfinite(x) for x in losses):
        fail("train: a loss is not finite")
    if not losses[-1] < losses[0]:
        fail(f"train: the loss did not fall over 11 steps ({losses[0]} -> {losses[-1]})")
    if launches != (len(losses), len(losses)):
        fail(f"train: {len(losses)} steps launched the training kernels {launches} times")

    # ---- ms/step and peak memory of both paths
    ms_per_step = {}
    for label, path in (("kernel path", kern), ("einsum path", plain)):
        for _ in range(2):
            run(path)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            run(path)
        torch.cuda.synchronize()
        ms = ms_per_step[label] = 1e3 * (time.perf_counter() - t0) / 5
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        run(path)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        log(f"train step {label} (B={TRAIN_B}x2 {TRAIN_CROP}^2 bf16): {ms:.3f} ms/step, "
            f"peak memory {peak / 2**30:.3f} GiB ({(peak - resident) / 2**30:.3f} GiB "
            f"above the {resident / 2**30:.3f} GiB resident) [{gpu}]")
    del kern, plain
    torch.cuda.empty_cache()

    # ---- the training kernels alone, at the step's shapes
    g = torch.Generator(device="cuda").manual_seed(30)
    y1, y2, do1, do2 = (torch.randn(TRAIN_B, TRAIN_P, K, generator=g, device="cuda")
                        .to(torch.bfloat16) for _ in range(4))
    mem = torch.randn(K, S, generator=g, device="cuda").to(torch.bfloat16)
    dcon = torch.ones((), device="cuda")
    out1, out2, _, lse, q = mt.memory_attention_train_forward(y1, y2, mem)
    fwd = cuda_ms(lambda: mt.memory_attention_train_forward(y1, y2, mem), 20)

    def backward():
        return mt.memory_attention_train_backward(y1, y2, mem, lse, q, out1, out2, do1, do2,
                                                  dcon)

    bwd = cuda_ms(backward, 10)
    n = TRAIN_B * TRAIN_P * K * S
    # the work the TPU kernels do (scripts/kernel_bounds.py): forward two
    # products a view, backward five; bf16 in and out, dM in f32
    fwd_bound = bound(2 * 4.0 * n, 2.0 * (4 * TRAIN_B * TRAIN_P * K + K * S) + 4,
                      PEAK_BF16_FLOPS)
    bwd_bound = bound(2 * 10.0 * n, 2.0 * (6 * TRAIN_B * TRAIN_P * K + K * S) + 4.0 * K * S,
                      PEAK_BF16_FLOPS)
    for what, fn, b_ms in (
            ("fwd", lambda: mt.memory_attention_train_forward(y1, y2, mem), fwd_bound[0]),
            ("bwd", backward, bwd_bound[0])):
        for name, (n_launch, ms) in launch_times(fn, 5).items():
            log(f"train kernel {what}, per launch: {name} {ms:.4f} ms ({n_launch:g} launches "
                f"a call; the call's bound {b_ms:.4f} ms) [{gpu}]")
    with torch.no_grad():
        fwd_plain = cuda_ms(lambda: mt.memory_attention_train_reference(y1, y2, mem), 5,
                            warmup=1)
    leaves = [t.clone().requires_grad_() for t in (y1, y2, mem)]
    outs = mt.memory_attention_train_reference(*leaves)
    bwd_plain = cuda_ms(lambda: torch.autograd.grad(outs, leaves, (do1, do2, dcon),
                                                    retain_graph=True), 5, warmup=1)
    del outs, leaves
    step_ms = ms_per_step["kernel path"]
    times = {"fwd": dict(ms=fwd, plain_ms=fwd_plain, bound_ms=fwd_bound[0],
                         bound_by=fwd_bound[1]),
             "bwd": dict(ms=bwd, plain_ms=bwd_plain, bound_ms=bwd_bound[0],
                         bound_by=bwd_bound[1])}
    for name, t in times.items():
        log(f"train kernel {name} B={TRAIN_B} P={TRAIN_P} K={K} S={S} x2 views bf16: "
            f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
            f"({t['bound_by']}; {t['ms'] / t['bound_ms']:.1f}x the bound) [{gpu}]")
    return launches, times, step_ms


def dmap_points(h, w, n, seed):
    """n points over the image and a 10-pixel margin around it; with n >= 12
    also points on every border, in (-1, 0) and outside; the last quarter
    masked off as pad rows."""
    g = torch.Generator().manual_seed(seed)
    pts = torch.rand(n, 2, generator=g) * torch.tensor([w + 20.0, h + 20.0]) - 10.0
    if n >= 12:
        pts[:8] = torch.tensor([[0.0, 0.0], [w - 0.5, h - 0.5], [-0.4, h / 2],
                                [w / 2, -0.7], [w - 1.0, 3.0], [5.0, h - 1.0],
                                [w + 0.5, 2.0], [-1.5, 4.0]])
    mask = torch.ones(n, dtype=torch.bool)
    mask[3 * n // 4:] = False
    return pts.cuda(), mask.cuda()


def check_dmap(dm):
    """Kernel #4 against its plain version at DMAP_SHAPES, and against the
    numpy golden at the first two. Returns the largest max_abs_err."""
    worst = 0.0
    for i, (h, w, n) in enumerate(DMAP_SHAPES):
        pts, mask = dmap_points(h, w, n, seed=40 + i)
        out = dm.gaussian_density(pts, mask, h, w)
        torch.cuda.synchronize()
        ref = dm.gaussian_density_reference(pts, mask, h, w)
        err = (out - ref).abs().max().item()
        ok = bool(torch.allclose(out, ref, **TOL_DMAP)) and out.shape == (h, w)
        if i < 2:
            golden = torch.from_numpy(dm.gaussian_density_fixed_np(
                (h, w), pts[mask].cpu().numpy())).cuda()
            ok = ok and bool(torch.allclose(out, golden, **TOL_DMAP))
        worst = max(worst, err)
        log(f"dmap kernel {h}x{w} N={n} ({int(mask.sum())} unmasked): max_abs_err "
            f"{err:.3e} vs plain, sum {out.sum().item():.4f} (tol {TOL_DMAP}) "
            f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"gaussian_density disagrees with its plain version or the golden "
                 f"({h}x{w}, N={n})")
    return worst


def time_dmap(dm, gpu):
    """Kernel #4 at 768x1024, N=1024 (all in the image, unmasked): its time
    and that of cuBLAS A . B^T on the prebuilt f32 A (HxN) and B (WxN), the
    medians of DMAP_TURNS turns of the two, the plain version's, and the
    bound: the map written once and the points read once
    over HBM, against the work these points need (each point's (2r+1)^2
    window clipped to the image, one multiply-add a pixel) over the f32
    CUDA-core peak."""
    h, w, n = 768, 1024, 1024
    g = torch.Generator(device="cuda").manual_seed(50)
    pts = torch.rand(n, 2, generator=g, device="cuda") * torch.tensor(
        [w - 1.0, h - 1.0], device="cuda")
    mask = torch.ones(n, dtype=torch.bool, device="cuda")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    plain = cuda_ms(lambda: dm.gaussian_density_reference(pts, mask, h, w), 20)
    r = dm.scipy_radius(4.0, 7.0 / 4.0)
    p = torch.trunc(pts).long()

    def axis(size, c):
        d = torch.arange(size, device="cuda")[:, None] - c[None, :]
        return torch.exp(-0.5 * (d.float() / 4.0) ** 2) * (d.abs() <= r)

    a, b = axis(h, p[:, 1]), axis(w, p[:, 0])
    # the kernel and cuBLAS in turns, medians: one reading each spreads by
    # tens of percent at these sub-0.1 ms times
    turns = [(cuda_ms(lambda: dm.gaussian_density(pts, mask, h, w), 200, warmup=5),
              cuda_ms(lambda: torch.matmul(a, b.t()), 200, warmup=5)) for _ in range(DMAP_TURNS)]
    kern, library = (float(np.median([t[i] for t in turns])) for i in range(2))
    log(f"dmap kernel vs cuBLAS A.B^T, {DMAP_TURNS} turns: "
        f"{', '.join(f'{k:.4f} / {c:.4f}' for k, c in turns)} ms [{gpu}]")
    torch.backends.cuda.matmul.allow_tf32 = tf32
    rows = (p[:, 1] + r).clamp_max(h - 1) - (p[:, 1] - r).clamp_min(0) + 1
    cols = (p[:, 0] + r).clamp_max(w - 1) - (p[:, 0] - r).clamp_min(0) + 1
    flops = 2.0 * float((rows * cols).sum())
    nbytes = 4.0 * h * w + 9.0 * n
    b_ms, b_by = bound(flops, nbytes, PEAK_F32_FLOPS)
    tpu_ms = bound(2.0 * h * w * n, 4.0 * (h * w + 3 * n), PEAK_F32_FLOPS)[0]
    log(f"dmap kernel {h}x{w} N={n} f32: gaussian_density {kern:.4f} ms (median; 200 "
        f"back-to-back calls, device events), plain {plain:.4f} ms, cuBLAS A.B^T {library:.4f} "
        f"ms (median), "
        f"bound {b_ms:.5f} ms ({b_by}: {nbytes / 1e6:.2f} MB, {flops / 1e6:.3f} MFLOP; "
        f"the TPU's dense form {tpu_ms:.4f} ms) [{gpu}]")
    return dict(ms=kern, plain_ms=plain, library_ms=library, bound_ms=b_ms, bound_by=b_by,
                bound_ms_dense_form=tpu_ms)


def write_dataset(root, seed=0):
    """The canonical layout: train 32, val 4, test 4 JPEGs of 768x1024 (a
    smooth random scene with noise) with 50 to 600 head points each."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    h, w = FRAME
    for split, n in (("train", 32), ("val", 4), ("test", 4)):
        os.makedirs(os.path.join(root, split))
        for k in range(n):
            low = rng.integers(0, 256, (12, 16, 3), dtype=np.uint8)
            img = np.asarray(Image.fromarray(low).resize((w, h), Image.BICUBIC), np.float32)
            img = np.clip(img + rng.normal(0, 12, img.shape), 0, 255).astype(np.uint8)
            Image.fromarray(img).save(os.path.join(root, split, f"IMG_{k}.jpg"), quality=90)
            pts = rng.uniform(0, [w, h], (int(rng.integers(50, 601)), 2)).astype(np.float32)
            np.save(os.path.join(root, split, f"IMG_{k}.npy"), pts)


# the JAX trainer's log.txt lines (dgvcc_tpu/train/trainer.py), numbers free
LOG_LINES = [re.compile(p) for p in (
    r"Start training and testing at \d{4}-\d\d-\d\d \d\d:\d\d:\d\d",
    r"Epoch \d+: Training loss: \d+\.\d{4} Version: sta_final",
    r"Epoch \d+: Val criterion: \d+\.\d{4} mse: \d+\.\d{4} best: \d+\.\d{4}, "
    r"time: \d+\.\d{4}",
    r"Epoch \d+: saving best model\.\.\.",
    r"Start testing at .+", r"Testing results: mae: \d+\.\d{4} mse: \d+\.\d{4} ",
    r"Saving test model\.\.\.", r"Testing results saved to .+", r"End testing at .+",
    r"Best epoch: \d+, best criterion: \d+\.\d+", r"Training results saved to .+",
    r"End training and testing at .+", r"Loading checkpoint from .+")]


class TimedLoader:
    """A loader that adds up the host time its consumer waits for batches."""

    def __init__(self, loader):
        self.loader, self.wait = loader, 0.0

    def __len__(self):
        return len(self.loader)

    def set_epoch(self, epoch):
        self.loader.set_epoch(epoch)

    def __iter__(self):
        it = iter(self.loader)
        while True:
            t = time.perf_counter()
            try:
                item = next(it)
            except StopIteration:
                return
            self.wait += time.perf_counter() - t
            yield item


def files_phase(ma, mt, dm, gpu, step_ms_repeated):
    """Phase 6: from files to a trained model. Returns kernel #4's launches
    on its path (the dmap_cli run)."""
    import glob
    import shutil
    import tempfile

    import yaml

    from dgvcc_tpu_torch.core.config import Config
    from dgvcc_tpu_torch.data import dmap_cli
    from dgvcc_tpu_torch.models.dg import MemoryBank
    from dgvcc_tpu_torch.serve import VideoCounter
    from dgvcc_tpu_torch.train.trainer import DGTrainer

    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        root = os.path.join(tmp, "data")
        t0 = time.perf_counter()
        write_dataset(root)
        log(f"files: wrote 40 JPEGs of {FRAME[0]}x{FRAME[1]} with points in "
            f"{time.perf_counter() - t0:.1f}s")

        # ---- density maps through the command line (kernel #4)
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, "-m", "dgvcc_tpu_torch.data.dmap_cli",
                              "--path", root], capture_output=True, text=True,
                             timeout=300, cwd=ROOT)
        wall = time.perf_counter() - t0
        if out.returncode:
            fail(f"dmap_cli exited {out.returncode}:\n{out.stderr[-3000:]}")
        last = out.stdout.strip().splitlines()[-1]
        log(f"dmap_cli ({wall:.1f}s with start-up): {last}")
        m = re.search(r"(\d+) of (\d+) images done in ([\d.]+)s; gaussian_density kernel "
                      r"launched (\d+)x", last)
        if not m or int(m.group(1)) != 40 or int(m.group(4)) != 40:
            fail(f"dmap_cli did not launch the kernel once per image (40): {last}")
        dmap_launches = int(m.group(4))
        for split, k in (("train", 0), ("val", 1), ("test", 3)):
            stem = os.path.join(root, split, f"IMG_{k}")
            got = np.load(stem + "_dmap.npy")
            want = dm.gaussian_density_fixed_np(FRAME, np.load(stem + ".npy"))
            err = float(np.abs(got - want).max())
            log(f"dmap_cli map {split}/IMG_{k}: {got.shape} {got.dtype}, sum "
                f"{got.sum():.4f}, max_abs_err vs numpy golden {err:.3e}")
            if got.dtype != np.float32 or not np.allclose(got, want, **TOL_DMAP):
                fail(f"dmap_cli wrote a map that disagrees with the golden ({stem})")
        img_fns = dmap_cli.list_images(root, ["train", "val", "test"])
        dmap_cli.generate(img_fns[:2], overwrite=True)  # warm: CUDA and the library
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dmap_cli.generate(img_fns, overwrite=True)
        per_image = 1e3 * (time.perf_counter() - t0) / len(img_fns)
        log(f"dmap_cli generate (in process, CUDA up): {per_image:.3f} ms/image at "
            f"{FRAME[0]}x{FRAME[1]} (read points, upload, kernel, download, np.save) "
            f"[{gpu}]")

        # ---- train_and_test with configs/sta_final.yml pointed at the files
        with open(os.path.join(ROOT, "configs", "sta_final.yml")) as f:
            raw = yaml.safe_load(f)
        for split in ("train", "val", "test"):
            raw[f"{split}_dataset"] = dict(raw[f"{split}_dataset"], params=dict(
                raw[f"{split}_dataset"]["params"], root=root))
        raw.update(num_epochs=2, log_dir=os.path.join(tmp, "logs"))
        cfg_path = os.path.join(tmp, "sta_final.yml")
        with open(cfg_path, "w") as f:
            yaml.safe_dump(raw, f)
        trainer = DGTrainer(Config.from_dict(raw))
        trainer.build()
        n_val, n_test = len(trainer.loaders["val"]), len(trainer.loaders["test"])
        steps = len(trainer.loaders["train"])
        train_ld, val_ld = (TimedLoader(trainer.loaders[k]) for k in ("train", "val"))
        trainer.loaders.update(train=train_ld, val=val_ld)
        marks = {"epoch": [], "val": []}
        run_epoch, run_val = trainer.train_epoch, trainer.validate

        def timed_epoch(*a):
            t, w = time.perf_counter(), train_ld.wait
            r = run_epoch(*a)
            marks["epoch"].append((t, time.perf_counter(), train_ld.wait - w))
            return r

        def timed_val(*a):
            t, w = time.perf_counter(), val_ld.wait
            r = run_val(*a)
            marks["val"].append((t, time.perf_counter(), val_ld.wait - w))
            return r

        trainer.train_epoch, trainer.validate = timed_epoch, timed_val
        einsum = [0]
        bank_forward = MemoryBank.forward

        def counting(self, y, mem):
            einsum[0] += not self.fused
            return bank_forward(self, y, mem)

        MemoryBank.forward = counting
        try:
            # ---- the main path of this phase: counts set to 0 just before
            ma.LAUNCHES = mt.FWD_LAUNCHES = mt.BWD_LAUNCHES = 0
            trainer.train_and_test()
            launches = {"memory_attention_fused": ma.LAUNCHES,
                        "memory_attention_train_fwd": mt.FWD_LAUNCHES,
                        "memory_attention_train_bwd": mt.BWD_LAUNCHES}
        finally:
            MemoryBank.forward = bank_forward
        text = open(os.path.join(trainer.log_dir, "log.txt")).read()
        n_tests = text.count("Testing results:")
        log(f"train_and_test (sta_final.yml, 2 epochs x {steps} steps of B=16, val "
            f"{n_val}, test {n_test} x {n_tests}): launches {launches}, einsum-path bank "
            f"forwards {einsum[0]}")
        if launches["memory_attention_train_fwd"] != 2 * steps or \
                launches["memory_attention_train_bwd"] != 2 * steps:
            fail(f"train: {2 * steps} steps launched the training kernels "
                 f"{launches['memory_attention_train_fwd']} / "
                 f"{launches['memory_attention_train_bwd']} times")
        if launches["memory_attention_fused"] < 2 * n_val + n_tests * n_test or einsum[0]:
            fail("eval: a validation or test forward did not go through kernel #1")
        for line in text.splitlines():
            if not any(p.fullmatch(line) for p in LOG_LINES):
                fail(f"log.txt line not of the JAX trainer's shapes: {line!r}")
        losses = [float(x) for x in re.findall(r"Training loss: (\S+)", text)]
        maes = [float(x) for x in re.findall(r"Val criterion: (\S+)", text)]
        log(f"train losses {losses}, val MAE {maes}")
        if len(losses) != 2 or len(maes) != 2 or not all(map(math.isfinite, losses + maes)):
            fail("train_and_test: a loss or val MAE is missing or not finite")

        # ---- times, from the wrappers' marks
        for e, ((t0, t1, tw), (v0, v1, vw)) in enumerate(zip(marks["epoch"], marks["val"])):
            log(f"epoch {e}: {t1 - t0:.3f} s; train loop with the loader "
                f"{1e3 * (v0 - t0) / steps:.3f} ms/step, of which waiting for the loader "
                f"{1e3 * tw / steps:.3f} ({steps} steps; phase 5, repeated batch: "
                f"{step_ms_repeated:.3f} ms/step); val {1e3 * (v1 - v0) / n_val:.3f} "
                f"ms/image, of which waiting for the loader {1e3 * vw / n_val:.3f} ({n_val} "
                f"of {FRAME[0]}x{FRAME[1]}); checkpoints and the rest "
                f"{t1 - v1:.3f} s [{gpu}]")

        # ---- checkpoints: strict loads, and --task test from best_* on the CLI
        best = glob.glob(os.path.join(trainer.log_dir, "best_*.pth"))
        last = os.path.join(trainer.log_dir, "last.pth")
        if len(best) != 1 or not os.path.exists(last):
            fail(f"checkpoints missing: last {os.path.exists(last)}, best {best}")
        params = raw["model"]["params"]
        for path in (last, best[0]):
            VideoCounter.from_checkpoint("final", path, dtype=torch.bfloat16, **params)
        log(f"VideoCounter.from_checkpoint strict-loaded {os.path.basename(last)} and "
            f"{os.path.basename(best[0])}")
        want = trainer.test(checkpoint=best[0])
        out = subprocess.run([sys.executable, "-m", "dgvcc_tpu_torch", "--config", cfg_path,
                              "--task", "test", "--ckpt", best[0]], capture_output=True,
                             text=True, timeout=300, cwd=ROOT)
        if out.returncode:
            fail(f"CLI test exited {out.returncode}:\n{out.stderr[-3000:]}")
        line = [ln for ln in out.stdout.splitlines() if ln.startswith("Testing results:")]
        got = dict(re.findall(r"(\w+): ([\d.]+)", line[-1])) if line else {}
        log(f"CLI --task test {os.path.basename(best[0])}: {line[-1] if line else None}; "
            f"in process: mae {want['mae']:.4f} mse {want['mse']:.4f}")
        for k in ("mae", "mse"):
            if k not in got or abs(float(got[k]) - want[k]) > TOL_CLI_TEST * max(want[k], 1.0):
                fail(f"CLI --task test {k} {got.get(k)} != in-process {want[k]}")
        return dmap_launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def check_counts(name, got, want, want_label="einsum path"):
    got, want = np.asarray(got), np.asarray(want)
    if not np.isfinite(got).all():
        fail(f"{name}: non-finite counts {got}")
    scale = max(1.0, float(np.abs(want).max()))
    diff = float(np.abs(got - want).max())
    log(f"{name}: counts {np.round(got[:4], 3).tolist()} ... {want_label} "
        f"{np.round(want[:4], 3).tolist()} ... max |diff| {diff:.4g} "
        f"(tol {TOL_COUNTS} x {scale:.4g})")
    if diff > TOL_COUNTS * scale:
        fail(f"{name}: counts disagree with the {want_label}")


def check_cli(frames, VideoCounter):
    """The serve task of the command line on JPEG frames (sta_final.yml:
    seed 2112, bf16, the kernel path by default), against a counter with
    the same seeded weights on the same decoded frames."""
    import tempfile

    from PIL import Image

    with tempfile.TemporaryDirectory() as tmp:
        for i, f in enumerate(frames):
            Image.fromarray(f).save(os.path.join(tmp, f"frame{i}.jpg"), quality=95)
        decoded = np.stack([np.asarray(Image.open(os.path.join(tmp, f"frame{i}.jpg"))
                                       .convert("RGB")) for i in range(len(frames))])
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "dgvcc_tpu_torch", "--config",
             os.path.join(ROOT, "configs", "sta_final.yml"), "--task", "serve",
             "--frames", tmp, "--batch", str(len(frames))],
            capture_output=True, text=True, timeout=300, cwd=ROOT)
    if out.returncode:
        fail(f"CLI serve exited {out.returncode}:\n{out.stderr[-3000:]}")
    lines = out.stdout.strip().splitlines()
    log(f"CLI serve ({time.perf_counter() - t0:.1f}s with start-up): {lines[-1]}")
    counts = np.array([float(ln.split()[1]) for ln in lines[:-1]])
    if len(counts) != len(frames):
        fail(f"CLI serve printed {len(counts)} counts for {len(frames)} frames")
    want = VideoCounter.from_checkpoint("final", None, dtype=torch.bfloat16,
                                        seed=2112).count_frames(decoded)
    check_counts("CLI serve sta_final.yml, 4 JPEG 768x1024", counts, want,
                 "VideoCounter")


def main():
    if not torch.cuda.is_available():
        print("[chip_smoke] CUDA is not available: this script runs on an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from dgvcc_tpu_torch.ops import _build
    from dgvcc_tpu_torch.ops import dmap as dm
    from dgvcc_tpu_torch.ops import mem_attention as ma
    from dgvcc_tpu_torch.ops import mem_attention_train as mt
    from dgvcc_tpu_torch.serve import VideoCounter

    t_start = time.perf_counter()
    gpu = card()
    print(gpu, flush=True)
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda "
        f"{torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    # ---- 1. build --------------------------------------------------------
    t0 = time.perf_counter()
    logs = _build.build_all()
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                log(f"nvcc {name}: {line.strip()}")
    log(f"built {sorted(logs) or 'nothing (up to date)'} in "
        f"{time.perf_counter() - t0:.1f}s")
    # the report of the library on disk (kept beside it), built now or not;
    # a serialised wgmma (C7512, C7514) or a spill slows the kernel and
    # passes every check of its values, so it fails here
    ptxas = {}
    for lib, kernel, what in (
            ("mem_attention", "mem_attention_bf16_kernelILi256E", "kernel #1"),
            ("mem_attention_train", "mat_fwd_bf16ILi256E", "kernel #2"),
            ("mem_attention_train", "mat_bwd_rows_bf16ILi256E", "kernel #3 rows"),
            ("mem_attention_train", "mat_bwd_cols_bf16ILi256E", "kernel #3 cols")):
        ptxas[kernel] = _build.ptxas_report(_build.build_log(lib), kernel)
        log(f"ptxas, {what} bf16 K=256: {' | '.join(ptxas[kernel])}")
        faults = _build.ptxas_faults(ptxas[kernel])
        if faults:
            fail(f"{what}'s bf16 K=256 build: {'; '.join(faults)}")
    ptxas_k256 = ptxas["mem_attention_bf16_kernelILi256E"]
    sass = check_sass(str(_build.library_path("mem_attention")), "mem_attention_bf16_kernel",
                      5, "kernel #1")
    sass_fwd = check_sass(str(_build.library_path("mem_attention_train")), "mat_fwd_bf16", 2,
                          "kernel #2")
    check_sass(str(_build.library_path("mem_attention_train")), "mat_bwd_(rows|cols)_bf16", 4,
               "kernel #3")

    # ---- 2. kernels vs plain versions -------------------------------------
    err_bf16 = check_kernel(ma, 4, P, torch.bfloat16, TOL_BF16, 1)
    log(f"kernel #1 bf16 B=4: max_abs_err {err_bf16:.3e} (the earlier mma.sync "
        f"kernel: {MMA_SYNC_BF16_ERR:.3e})")
    err_f32 = check_kernel(ma, 4, P, torch.float32, TOL_F32, 2)
    check_kernel(ma, 3, 6400 + 37, torch.bfloat16, TOL_BF16, 3)
    check_kernel(ma, 3, 6400 + 37, torch.float32, TOL_F32, 4)
    err_edges = max(check_kernel(ma, b, p, torch.bfloat16, TOL_BF16, 60 + i, k, s)
                    for i, (b, p, k, s) in enumerate(EDGES_BF16))
    # the plain versions' float32 products in full float32 for these
    # comparisons (TF32 off); the flags are put back after them
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    train_bf16 = check_train_kernels(mt, TRAIN_B, TRAIN_P, torch.bfloat16, 5)
    train_f32 = check_train_kernels(mt, TRAIN_B, TRAIN_P, torch.float32, 6)
    check_train_kernels(mt, 3, 6400 + 37, torch.bfloat16, 7)
    check_train_kernels(mt, 3, 6400 + 37, torch.float32, 8)
    near = {(dtype, eps): check_train_forward_near(mt, dtype, eps, 70 + i)
            for i, (dtype, eps) in enumerate((d, e) for d in (torch.bfloat16, torch.float32)
                                             for e in NEAR_EPS)}
    dmap_err = check_dmap(dm)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32

    # ---- 3. serve the main path -------------------------------------------
    torch.backends.cudnn.benchmark = True
    counter = VideoCounter.from_checkpoint("final", None, dtype=torch.bfloat16,
                                           fused_mem=True, seed=0)
    plain = VideoCounter.from_checkpoint("final", None, dtype=torch.bfloat16,
                                         fused_mem=False, seed=0)
    for (k1, v1), (k2, v2) in zip(counter.model.state_dict().items(),
                                  plain.model.state_dict().items()):
        if k1 != k2 or not torch.equal(v1, v2):
            fail(f"seeded weights differ between the two counters at {k1}")
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (4,) + FRAME + (3,), dtype=np.uint8)
    batches = [rng.integers(0, 256, (16,) + FRAME + (3,), dtype=np.uint8)
               for _ in range(4)]
    big = rng.integers(0, 256, (2, 1080, 1920, 3), dtype=np.uint8)

    def tiled(c, on):
        c.tile_threshold = 1536 if on else 4096

    paths = [
        ("count_frames B=4 768x1024", lambda c: c.count_frames(frames)),
        ("stream 4x B=16 768x1024",
         lambda c: np.concatenate(list(c.stream(iter(batches), prefetch=2)))),
        ("count_frames B=2 1080x1920 padded", lambda c: c.count_frames(big)),
        ("count_frames B=2 1080x1920 tiled 2x3x768",
         lambda c: (tiled(c, True), c.count_frames(big), tiled(c, False))[1]),
    ]
    launches = 0
    for name, run in paths:
        ma.LAUNCHES = 0
        fused_counts = run(counter)
        n = ma.LAUNCHES
        launches += n
        log(f"{name}: memory_attention_fused launched {n}x")
        if n == 0:
            fail(f"{name}: the serving path never launched the kernel")
        check_counts(name, fused_counts, run(plain))
    check_cli(frames, VideoCounter)

    # ---- 4. times ---------------------------------------------------------
    log(f"card: {gpu}")
    for b in (1, 4, 16):
        f = np.ascontiguousarray(batches[0][:b])
        for c in (counter, plain):
            c.count_frames(f)
        for label, c in (("fused_mem=True", counter), ("fused_mem=False", plain)):
            # B<=4 host-clock times spread by several percent over 8 calls
            iters = 24 if b < 16 else 4
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(iters):
                c.count_frames(f)
            dt = time.perf_counter() - t0
            log(f"serve count_frames B={b} 768x1024 bf16 {label}: "
                f"{b * iters / dt:.2f} frames/s ({1e3 * dt / (b * iters):.3f} "
                f"ms/frame) [{gpu}]")
    list(counter.stream(iter(batches[:2])))
    t0 = time.perf_counter()
    n_frames = sum(len(x) for x in counter.stream(iter(batches + batches), prefetch=2))
    dt = time.perf_counter() - t0
    log(f"serve stream 8x B=16 768x1024 bf16 fused_mem=True: "
        f"{n_frames / dt:.2f} frames/s [{gpu}]")

    times = {}
    for b in (1, 4):
        g = torch.Generator(device="cuda").manual_seed(10 + b)
        y = torch.randn(b, P, K, generator=g, device="cuda").to(torch.bfloat16)
        mem = torch.randn(K, S, generator=g, device="cuda").to(torch.bfloat16)
        memt = mem.t().contiguous()[None, None].expand(b, 1, S, K)
        kern = cuda_ms(lambda: ma.memory_attention_fused(y, mem), 20)
        ref = cuda_ms(lambda: ma.memory_attention_reference(y, mem), 5, warmup=1)
        sdpa = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            y[:, None], memt, memt, scale=1.0 / math.sqrt(K)), 20)
        flops = 4.0 * b * P * K * S
        nbytes = 2.0 * (2 * b * P * K + K * S)
        bound_ops, bound_bytes = 1e3 * flops / PEAK_BF16_FLOPS, 1e3 * nbytes / PEAK_HBM_BYTES
        times[b] = dict(ms=kern, plain_ms=ref, library_ms=sdpa,
                        bound_ms=max(bound_ops, bound_bytes),
                        bound_by="operations" if bound_ops >= bound_bytes else "bytes")
        log(f"kernel B={b} P={P} K={K} S={S} bf16: memory_attention_fused "
            f"{kern:.4f} ms, plain {ref:.4f} ms, SDPA {sdpa:.4f} ms, bound "
            f"{times[b]['bound_ms']:.4f} ms ({times[b]['bound_by']}; "
            f"{flops / kern / 1e9:.1f} TFLOP/s achieved) [{gpu}]")
    g = torch.Generator(device="cuda").manual_seed(20)
    y = torch.randn(4, P, K, generator=g, device="cuda")
    mem = torch.randn(K, S, generator=g, device="cuda")
    kern32 = cuda_ms(lambda: ma.memory_attention_fused(y, mem), 5)
    log(f"kernel B=4 f32: memory_attention_fused {kern32:.4f} ms, bound "
        f"{1e3 * 4.0 * 4 * P * K * S / PEAK_F32_FLOPS:.4f} ms (f32 CUDA-core "
        f"peak) [{gpu}]")
    dmap_times = time_dmap(dm, gpu)

    # ---- 5. train the main path ----------------------------------------------
    train_launches, train_times, step_ms = train_phase(mt, gpu)

    # ---- 6. from files to a trained model ----------------------------------
    dmap_launches = files_phase(ma, mt, dm, gpu, step_ms)
    log(f"total {time.perf_counter() - t_start:.1f}s")

    # ---- 7. result --------------------------------------------------------
    t4 = times[4]
    train_shape = {"B": TRAIN_B, "P": TRAIN_P, "K": K, "S": S, "views": 2,
                   "dtype": "bfloat16"}
    source = "dgvcc_tpu_torch/csrc/mem_attention_train.cu"
    print(json.dumps({"kernels": [{
        "name": "memory_attention_fused", "route": "cuda",
        "source": "dgvcc_tpu_torch/csrc/mem_attention.cu",
        "replaces": "dgvcc_tpu/ops/mem_attention.py:59",
        "launches": launches, "ok": True,
        "max_abs_err": err_bf16, "max_err": err_bf16, "max_abs_err_f32": err_f32,
        "max_abs_err_edges": err_edges, "ptxas_k256": ptxas_k256, "sass": sass,
        "ms": t4["ms"], "plain_ms": t4["plain_ms"], "bound_ms": t4["bound_ms"],
        "bound_by": t4["bound_by"], "library_ms": t4["library_ms"],
        "ms_b1": times[1]["ms"], "library_ms_b1": times[1]["library_ms"],
        "bound_ms_b1": times[1]["bound_ms"],
        "shape": {"B": 4, "P": P, "K": K, "S": S, "dtype": "bfloat16"}}, {
        "name": "memory_attention_train_fwd", "route": "cuda", "source": source,
        "replaces": "dgvcc_tpu/ops/mem_attention_train.py:134",
        "launches": train_launches[0], "ok": True,
        "max_abs_err": train_bf16["out"], "max_err": train_bf16["out"],
        "max_abs_err_f32": train_f32["out"], "out_rel_norm_err": train_bf16["out_rel"],
        "loss_con_rel_err": train_bf16["con_rel"],
        "loss_con_rel_err_near": {str(e): near[torch.bfloat16, e][0] for e in NEAR_EPS},
        "q_rel_err_near": {str(e): near[torch.bfloat16, e][1] for e in NEAR_EPS},
        "ptxas_k256": ptxas["mat_fwd_bf16ILi256E"], "sass": sass_fwd,
        **train_times["fwd"], "library_ms": None, "shape": train_shape}, {
        "name": "memory_attention_train_bwd", "route": "cuda", "source": source,
        "replaces": "dgvcc_tpu/ops/mem_attention_train.py:177",
        "launches": train_launches[1], "ok": True,
        "max_abs_err": train_bf16["dy"], "max_err": train_bf16["dy"],
        "max_abs_err_f32": train_f32["dy"], "dy_rel_norm_err": train_bf16["dy_rel"],
        "dm_rel_norm_err": train_bf16["dm_rel"],
        "loss_con_grad_rel_norm_err": max(train_bf16["con_dy_rel"], train_bf16["con_dm_rel"]),
        **train_times["bwd"], "library_ms": None, "shape": train_shape}, {
        "name": "gaussian_density", "route": "cuda",
        "source": "dgvcc_tpu_torch/csrc/dmap.cu",
        "replaces": "dgvcc_tpu/ops/dmap.py:247",
        "launches": dmap_launches, "ok": True,
        "max_abs_err": dmap_err, "max_err": dmap_err, **dmap_times,
        "shape": {"H": FRAME[0], "W": FRAME[1], "N": 1024, "sigma": 4.0, "radius": 7,
                  "dtype": "float32"}}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
