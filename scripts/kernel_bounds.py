#!/usr/bin/env python3
"""Least time an H100 could take for each TPU kernel of the repo.

For every ``pl.pallas_call`` of the JAX package, at the shapes of the
path that runs it: the operations it must do over the card's dense peak
for their type, and the bytes it must move (each input read once, each
output written once) over HBM bandwidth; the bound is the larger. Pure
arithmetic, no GPU needed:

    python3 scripts/kernel_bounds.py
"""

PEAK = {"bf16": 989e12, "f32": 67e12}   # H100 SXM dense FLOP/s (tensor cores, CUDA cores)
HBM = 3.35e12                           # H100 SXM bytes/s


def row(name, flops, kind, nbytes):
    t_ops, t_bytes = 1e3 * flops / PEAK[kind], 1e3 * nbytes / HBM
    by = "operations" if t_ops >= t_bytes else "bytes"
    print(f"{name:<58} {flops / 1e9:9.1f} GFLOP ({kind}) {t_ops:8.4f} ms | "
          f"{nbytes / 1e6:8.1f} MB {t_bytes:8.4f} ms | bound {max(t_ops, t_bytes):.4f} ms ({by})")


def main():
    K, S = 256, 1024
    for b in (1, 4, 16):  # serving: 768x1024 frame -> P = 192 * 256
        p = 192 * 256
        row(f"#1 memory_attention_fused serve B={b} P={p}",
            4.0 * b * p * K * S, "bf16", 2.0 * (2 * b * p * K + K * S))
    b, p = 16, 80 * 80  # training: 320^2 crops at stride 4, two views
    row(f"#2 memory_attention_train fwd B={b} P={p} x2 views",
        2 * 4.0 * b * p * K * S, "bf16",
        2.0 * (4 * b * p * K + K * S) + 4)
    # backward recomputes the logits and forms dp, dy and dM (two products)
    # for each view: 10 products of P*K*S multiply-adds in all
    row(f"#3 memory_attention_train bwd B={b} P={p} x2 views",
        2 * 10.0 * b * p * K * S, "bf16",
        2.0 * (6 * b * p * K + K * S) + 4.0 * K * S)
    # the work the port's kernels (csrc/mem_attention_train.cu) do for the
    # same function: the forward computes the logits twice (6 products),
    # the backward recomputes logits and dout . M in both its row and its
    # column kernel and sweeps S once more for D (18 products)
    row(f"#2 as ported (6 products) B={b} P={p} x2 views",
        2 * 6.0 * b * p * K * S, "bf16", 2.0 * (4 * b * p * K + K * S) + 4)
    row(f"#3 as ported (18 products) B={b} P={p} x2 views",
        2 * 18.0 * b * p * K * S, "bf16",
        2.0 * (6 * b * p * K + K * S) + 4.0 * K * S)
    h, w, n = 768, 1024, 1024  # density map of a 768x1024 image, 1024 points
    row(f"#4 gaussian_density_pallas {h}x{w} N={n}",
        2.0 * h * w * n, "f32", 4.0 * (h * w + 3 * n))
    # the port's kernel (csrc/dmap.cu) does the sparse work instead: one
    # multiply-add per pixel of each point's (2r+1)^2 window (r = 7), the
    # map written once, the points (x, y f32 and a mask byte) read once;
    # each of the (h/32)*(w/32) blocks also tests every point for its tile
    # (from L2, not counted as HBM bytes)
    r = 7
    row(f"#4 as ported (sparse) {h}x{w} N={n}, {h // 32 * (w // 32)} tiles",
        2.0 * (2 * r + 1) ** 2 * n, "f32", 4.0 * h * w + 9.0 * n)


if __name__ == "__main__":
    main()
