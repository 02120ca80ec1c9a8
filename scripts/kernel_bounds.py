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
    h, w, n = 768, 1024, 1024  # density map of a 768x1024 image, 1024 points
    row(f"#4 gaussian_density_pallas {h}x{w} N={n}",
        2.0 * h * w * n, "f32", 4.0 * (h * w + 3 * n))


if __name__ == "__main__":
    main()
