"""Microbenchmarks of the solver's hot operations on the card.

Port of ``scripts/micro_bench.py``. Run from the repository root on a
machine with one CUDA GPU:

    python -m dpgo_ros_tpu_torch.scripts.micro_bench [--out PATH]

On the sphere2500 world (``--world``; 5 robots, fp32) at a random state
(Stiefel blocks and Gaussian translations from a seeded generator, a
perturbation V = 0.01·N(0, 1)):

* per call (CUDA events around ``--iters`` calls after a warm one, ms per
  call): the port's plain operations ``egrad`` through the pull index and
  through a scatter (``index_add_``), ``cost``, ``precond_blocks``,
  ``precond_inverse``, ``precond_solve``, ``precond_apply``,
  ``retract_polar`` (eigh), ``retract_polar_ns``, ``proj_tangent``, and the
  plain ``rtr_solve`` of robot 0's block;
* the RTR rows at (TR, tCG) budgets (1, 10), (1, 50), (3, 50): K1 on robot
  0's mask (its window, ``hbm_rtr.prepare_mask_window``) beside the plain
  ``rtr_solve``, ms per call and the tCG iterations of a solve;
* the Newton–Schulz retraction against eigh: the largest difference and
  the NS result's distance from the manifold;
* per op without dispatch: 200 applications of ``egrad``, ``rhess_vp``,
  ``proj_tangent``, the NS retraction and ``precond_apply`` captured once
  as a CUDA graph and replayed (the counterpart of the JAX script's
  ``fori_loop`` inside one jit), ms per application.

``--device cpu`` runs the same on the CPU with a host clock and no graph
(numbers of the CPU, not of a card). Prints progress on stderr and one
JSON line on stdout.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from dpgo_ros_tpu_torch.models.local_solvers import RTRParams, rtr_solve
from dpgo_ros_tpu_torch.models.problem import LiftedProblem
from dpgo_ros_tpu_torch.ops import fused_rtr, hbm_rtr, quadratic, stiefel
from dpgo_ros_tpu_torch.scripts import common, roofline
from dpgo_ros_tpu_torch.scripts.common import log

RTR_BUDGETS = ((1, 10), (1, 50), (3, 50))
LOOP = 200


def egrad_scatter(X: torch.Tensor, e) -> torch.Tensor:
    """``quadratic.egrad`` with the edge terms accumulated by a scatter
    (``index_add_``) instead of the pull index's gather."""
    r1, r2 = quadratic.residuals(X, e)
    kw, tw = e.effective_weights()
    kr1 = 2.0 * kw[:, None, None] * r1
    tr2 = 2.0 * tw[:, None] * r2
    gYi = -(kr1 @ e.R.transpose(-1, -2)) - tr2[:, :, None] * e.t[:, None, :]
    gi = torch.cat([gYi, -tr2[..., None]], dim=-1)
    gj = torch.cat([kr1, tr2[..., None]], dim=-1)
    out = torch.zeros_like(X)
    return out.index_add_(0, e.src, gi).index_add_(0, e.dst, gj)


def timer(device):
    """ms per call of ``fn`` over ``iters`` calls after a warm one: CUDA
    events on the card, the host clock on the CPU."""
    cuda = torch.device(device).type == "cuda"

    def ms(fn, iters: int) -> float:
        fn()
        common.sync(device)
        if cuda:
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(iters):
                fn()
            b.record()
            b.synchronize()
            return a.elapsed_time(b) / iters
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    return ms


def looped_ms(op, x0: torch.Tensor, device, steps: int = LOOP) -> dict:
    """ms per application of ``op`` over ``steps`` chained applications: a
    CUDA graph captured once and replayed on the card, an eager loop on the
    CPU."""
    def chain(x):
        for _ in range(steps):
            x = op(x)
        return x

    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        chain(x0)
        return {"ms_per_op": (time.perf_counter() - t0) * 1e3 / steps, "graph": False}
    static = x0.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        chain(static)  # warm outside the capture
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        chain(static)
    g.replay()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    g.replay()
    b.record()
    b.synchronize()
    return {"ms_per_op": a.elapsed_time(b) / steps, "graph": True}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--world", default="sphere2500", choices=sorted(roofline.STAND_INS))
    p.add_argument("--iters", type=int, default=50, help="calls per timed row")
    common.add_args(p)
    a = common.parse(p, argv, "micro_bench")
    device, dt = a.device, common.DTYPES[a.dtype]
    card = common.card(device)
    log(f"card {card}; {a.dtype} on {device}")
    data, _, _, _ = roofline.load_world(a.world, num_robots=5)
    prob = LiftedProblem.from_data(data, r=5, dtype=dt, device=device)
    e, n = prob.edges, prob.n
    gen = torch.Generator().manual_seed(0)
    Y = stiefel.random_stiefel(gen, n, 5, 3, dtype=dt, device=device)
    pt = torch.randn((n, 5), generator=gen, dtype=dt).to(device)
    X = stiefel.join(Y, pt).contiguous()
    V = (torch.randn(X.shape, generator=gen, dtype=dt) * 0.01).to(device)
    mask = prob.block_mask(0)
    P = quadratic.precond_blocks(e, n)
    Pinv = quadratic.precond_inverse(P).contiguous()
    ms = timer(device)
    rows = {}

    def row(name, fn, iters=a.iters):
        rows[name] = ms(fn, iters)
        log(f"{name:34s} {rows[name] * 1e3:10.1f} us")

    row("egrad (pull)", lambda: quadratic.egrad(X, e))
    row("egrad (scatter)", lambda: egrad_scatter(X, e))
    row("cost", lambda: quadratic.cost(X, e))
    row("precond_blocks (pull)", lambda: quadratic.precond_blocks(e, n))
    row("precond_inverse", lambda: quadratic.precond_inverse(P))
    row("precond_solve (chol per call)", lambda: quadratic.precond_solve(P, V))
    row("precond_apply", lambda: quadratic.precond_apply(Pinv, V))
    row("retract_polar (eigh)", lambda: stiefel.retract_polar(X, V))
    row("retract_polar_ns", lambda: stiefel.retract_polar_ns(X, V))
    row("proj_tangent", lambda: stiefel.proj_tangent(X, V))
    ref = RTRParams(max_iterations=3, max_tcg_iterations=50, gradnorm_tol=0.5)
    row("rtr block update (plain)", lambda: rtr_solve(X, e, mask, Pinv, ref), iters=10)
    # K1 on robot 0's mask beside the plain solve
    m0 = mask.reshape(-1)
    w0 = hbm_rtr.prepare_mask_window(prob, m0)
    rtr = []
    before = common.counts()
    for ti, tcg in RTR_BUDGETS:
        prm = RTRParams(max_iterations=ti, max_tcg_iterations=tcg, gradnorm_tol=0.5)
        k1 = lambda: fused_rtr.rtr_solve_fused(X, m0, Pinv, e, prm, windows=w0, row=0)
        _, stats = k1()
        r = {"tr": ti, "tcg": tcg, "k1_ms": ms(k1, 10),
             "plain_ms": ms(lambda: rtr_solve(X, e, mask, Pinv, prm), 10),
             "k1_tcg_per_solve": int(stats[fused_rtr.S_TCG])}
        log(f"rtr ti={ti} tcg={tcg}: K1 {r['k1_ms'] * 1e3:.1f} us, plain "
            f"{r['plain_ms'] * 1e3:.1f} us, {r['k1_tcg_per_solve']} tCG")
        rtr.append(r)
    rtr_launches = common.launched(before)
    # the Newton-Schulz retraction against eigh
    ra, rb = stiefel.retract_polar(X, V), stiefel.retract_polar_ns(X, V)
    ns = {"max_diff": float((ra - rb).abs().max()),
          "on_manifold": float(stiefel.check_on_manifold(rb))}
    log(f"NS vs eigh max diff: {ns['max_diff']}  on-manifold: {ns['on_manifold']}")
    # per op without dispatch: one graph of LOOP chained applications
    looped = {
        "egrad": looped_ms(lambda Z: quadratic.egrad(Z, e) * 1e-9 + Z, X, device),
        "rhess_vp": looped_ms(lambda Z: quadratic.rhess_vp(X, Z, e) * 1e-9 + Z, V, device),
        "proj_tangent": looped_ms(lambda Z: stiefel.proj_tangent(X, Z) * 1e-9 + Z, V,
                                  device),
        "retract_ns": looped_ms(lambda Z: stiefel.retract_polar_ns(Z, V * 1e-6), X, device),
        "precond_apply": looped_ms(lambda Z: quadratic.precond_apply(Pinv, Z) * 1e-9 + Z,
                                   V, device),
    }
    for k, v in looped.items():
        log(f"looped {k:28s} {v['ms_per_op'] * 1e3:10.1f} us/op (graph {v['graph']})")
    out = {"world": a.world, "poses": n, "edges": e.num_edges, "ms_per_call": rows,
           "rtr": rtr, "rtr_launches": rtr_launches, "ns_vs_eigh": ns,
           "looped_ms_per_op": looped, "loop_steps": LOOP,
           "timer": "cuda events" if torch.device(device).type == "cuda" else "host clock",
           "card": card, "device": device, "dtype": a.dtype}
    return common.emit(out, a.out)


if __name__ == "__main__":
    main()
