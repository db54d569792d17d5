"""Operations and bytes of the port's kernels, and the card's peaks.

The functions count what the algorithm needs from the shapes and from
the iterations each tile ran, whatever implements it: a later kernel is
measured against the same work. They are this benchmark's own copies of
the counts the port's bring-up used (chip_smoke.py's k1_work,
k2_cone_work, k3_work), with the cone's block count taken from the
configuration's shapes.

Peaks: NVIDIA's data sheet for the H100 SXM, dense, at its 700 W limit:
67 TFLOP/s float32 outside the tensor cores, 495 TFLOP/s TF32 on them
(a float32-accurate product takes three TF32 products), 3.35 TB/s HBM3.
"""

from __future__ import annotations

PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES_S = 3.35e12


def bound_s(flops: float, nbytes: float, tf32x3: bool = False) -> float:
    """The least time the card could take: the larger of the operations
    at the peak (three TF32 products for each float32 one with tf32x3)
    and the bytes at the memory rate."""
    t_op = (3 * flops / PEAK_TF32_FLOPS if tf32x3
            else flops / PEAK_F32_FLOPS)
    return max(t_op, nbytes / PEAK_BYTES_S)


def k1_work(B, cap, P, tile, iters, converged, n_iters=300,
            stop_at_eps=True, check_every=25):
    """One K1 phase solve of B problems at `cap` stance slots over P
    phases: per problem-iteration the metric step (2n^2), the two Gram
    products (2 * 2 cap^2 6), the slab, cone and elementwise passes
    (~48 kflop at cap 32), and the termination test every `check_every`
    iterations, over the iterations each tile ran: with stop_at_eps, a
    tile whose problems all converged ran to its last problem's first
    passing check, every other tile the whole budget. iters and
    converged are sequences of B. Bytes: every input read once and every
    output written once."""
    n, m = 3 * cap, 5 * cap
    hx = 24 * cap * cap + 63 * cap + 2 * n
    per_it = 12 * m + 13 * cap + 5 * n + 2 * n * n + hx
    per_check = hx + 7 * cap + 6 * m + 6 * n
    total_it = 0
    for t in range(B // tile):
        its = iters[t * tile:(t + 1) * tile]
        cv = converged[t * tile:(t + 1) * tile]
        ran = max(its) if stop_at_eps and all(cv) else n_iters
        total_it += ran * tile
    flops = total_it * per_it + (total_it / check_every + B) * per_check
    nbytes = 4 * (B * (n + 9 * cap + n + m)
                  + P * (n * n + 2 * cap * cap) + 2 * m + B // tile
                  + B * (n + 3 * m + 5))
    return flops, nbytes


def k2_cone_work(R, n, m, n_iters, n_blocks, full, k_ref=False):
    """One K2 launch of R problems when A is the friction-cone matrix of
    `n_blocks` 5 x 3 blocks (and, `full`, an identity row a variable):
    per problem-iteration K^-1 b (2n^2), the two structured products A'w
    and A xt (2 flop for each of a block's 9 nonzeros, 1 an identity
    row) and the elementwise updates, with k_ref 8n^2 + 4n more; plus
    z = A x0 and the residual pass. Bytes: K^-1 and P (and K) a problem,
    the vectors in and out."""
    a_prod = 18 * n_blocks + (n if full else 0)
    per_it = 2 * n * n + 2 * a_prod + 12 * m + 6 * n
    if k_ref:
        per_it += 8 * n * n + 4 * n
    once = a_prod + (2 * a_prod + 2 * n * n + 4 * m + 4 * n)
    flops = R * (n_iters * per_it + once)
    mats = 3 if k_ref else 2
    nbytes = 4 * R * (mats * n * n + 3 * n + 4 * m + n + 2 * m + 4)
    return flops, nbytes


def k3_work(B, n, ns_iters):
    """One K3 launch: 2 ns_iters + 1 products of n x n matrices (2n^3
    each) and the 2n^2 of the update and the residual; bytes: K and X0
    read, X and the residual written."""
    flops = B * ((2 * ns_iters + 1) * 2 * n ** 3 + 2 * ns_iters * n * n
                 + 2 * n * n)
    return flops, 4 * B * (3 * n * n + 1)


def roofline_pct(bound_total_s: float, kernel_s: float):
    """A kernel's share of its roofline, in percent; None where no kernel
    time was read."""
    if kernel_s <= 0 or bound_total_s <= 0:
        return None
    return 100.0 * bound_total_s / kernel_s
