"""One asynchronous (ASAPP) tick as a hand-written CUDA kernel (K3).

Port of ``dpgo_ros_tpu/ops/fused_asapp.py::asapp_tick_fused`` (the Pallas
kernel built by ``_make_asapp_kernel``). One tick updates every robot at
once: robot k sees its own block of X fresh and every other pose from the
ring-buffer slot ``delays[k] mod (K+1)``, runs ``steps_per_tick``
(preconditioned) Riemannian-gradient steps with the Newton–Schulz
retraction on its block, and the new state takes each robot's block from
its own view. The kernel source ``csrc/asapp_tick.cu`` says what bounds it
and how it is laid out; it is built with the package's other kernels by
``fused_rtr.build_all()``.

:func:`asapp_tick_fused` launches K3 for CUDA tensors and raises if it
cannot be built or launched; for CPU tensors it runs the plain version
:func:`asapp_tick_fused_ref`. No path falls back from one to the other.

Layouts are the public ones: X (n, r, d+1), the ring buffer
(K+1, n, r, d+1), robot masks (R, n). The TPU kernel's transposed
(C, n_pad) layout, its 8-row slot padding and its lane windows are not
carried over. The ring-buffer write of the pre-tick state is the caller's
(after the tick, as its own copy), since other robots may read that slot
as stale within the tick.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from dpgo_ros_tpu_torch.ops import fused_rtr, quadratic, stiefel
from dpgo_ros_tpu_torch.ops.quadratic import EdgeSet

# launches of K3 (not of the plain version)
TICK_LAUNCHES = 0


def _checked(X, hist, masks, Pinv, edges, delays, offsets, fdt):
    """Raise on operands the kernel cannot take; returns (κ_eff, τ_eff)."""
    who = "asapp_tick_fused"
    n, r, dp1 = X.shape
    if dp1 - 1 not in (2, 3):
        raise ValueError(f"{who}: d={dp1 - 1} (kernel takes 2 or 3)")
    if not 1 <= r <= fused_rtr.MAX_RANK:
        raise ValueError(f"{who}: r={r} (kernel takes 1..{fused_rtr.MAX_RANK})")
    if hist.dim() != 4 or hist.shape[1:] != X.shape:
        raise ValueError(f"{who}: hist shape {tuple(hist.shape)} for X {tuple(X.shape)}")
    R = masks.shape[0]
    if masks.shape != (R, n) or delays.shape != (R,) or offsets.shape != (R + 1,):
        raise ValueError(
            f"{who}: masks {tuple(masks.shape)}, delays {tuple(delays.shape)}, "
            f"offsets {tuple(offsets.shape)} for n={n}"
        )
    if Pinv.shape != (n, dp1, dp1):
        raise ValueError(f"{who}: Pinv shape {tuple(Pinv.shape)}")
    if edges.pull.dim() != 2 or edges.pull.shape[0] != n:
        raise ValueError(f"{who}: pull shape {tuple(edges.pull.shape)}")
    kw, tw = edges.effective_weights()
    tensors = {
        "X": X, "hist": hist, "masks": masks, "delays": delays, "Pinv": Pinv,
        "src": edges.src, "dst": edges.dst, "R": edges.R, "t": edges.t,
        "kw": kw, "tw": tw, "pull": edges.pull, "offsets": offsets,
    }
    want = {"delays": torch.int32, "src": torch.int64, "dst": torch.int64,
            "pull": torch.int32, "offsets": torch.int32}
    for name, ten in tensors.items():
        if ten.device != X.device:
            raise ValueError(f"{who}: {name} on {ten.device}, X on {X.device}")
        if ten.dtype != want.get(name, fdt):
            raise TypeError(f"{who}: {name} is {ten.dtype}, expected {want.get(name, fdt)}")
        if not ten.is_contiguous():
            raise ValueError(f"{who}: {name} is not contiguous")
    return kw, tw


def asapp_tick_fused(
    X: torch.Tensor,
    hist: torch.Tensor,
    masks: torch.Tensor,
    Pinv: torch.Tensor,
    edges: EdgeSet,
    delays: torch.Tensor,
    gamma: float,
    steps_per_tick: int,
    use_precond: bool,
    offsets: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One ASAPP tick of every robot (K3).

    X (n, r, d+1); hist (K+1, n, r, d+1) ring buffer; masks (R, n), robot
    k's mask 1 on its block ``[offsets[k], offsets[k+1])`` and 0 elsewhere;
    Pinv (n, d+1, d+1) the damped block-Jacobi inverse; delays (R,) int32
    stale slots (taken mod K+1); gamma the stepsize of this tick; offsets
    (R+1,) int32 robot block bounds covering [0, n).

    Returns (X_new, moved (R,)): moved_k = ‖(X_new − X)·mask_k‖_F.
    """
    if X.device.type not in ("cpu", "cuda"):
        raise ValueError(f"asapp_tick_fused: unsupported device {X.device}")
    on_card = X.device.type == "cuda"
    fdt = torch.float32 if on_card else X.dtype
    kw, tw = _checked(X, hist, masks, Pinv, edges, delays, offsets, fdt)
    if not on_card:
        return asapp_tick_fused_ref(X, hist, masks, Pinv, edges, delays, gamma,
                                    steps_per_tick, use_precond, offsets)
    return _launch(X, hist, masks, Pinv, edges, delays, float(gamma),
                   int(steps_per_tick), bool(use_precond), offsets, kw, tw)


def _launch(X, hist, masks, Pinv, edges, delays, gamma, steps, use_precond,
            offsets, kw, tw):
    global TICK_LAUNCHES
    n, r, dp1 = X.shape
    d = dp1 - 1
    E = edges.num_edges
    R = masks.shape[0]
    lib = fused_rtr._library(fused_rtr.TICK_SOURCE)
    ws = lib.dpgo_asapp_tick_workspace_floats(d, r, n, E, R)
    X_out = torch.empty_like(X)
    moved = torch.empty(R, dtype=torch.float32, device=X.device)
    work = torch.empty(ws, dtype=torch.float32, device=X.device)
    p = lambda t: ctypes.c_void_p(t.data_ptr())
    with torch.cuda.device(X.device):  # launch on X's card, in its stream
        rc = lib.dpgo_asapp_tick(
            d, r, n, E, int(edges.pull.shape[1]), R, int(hist.shape[0]), steps,
            int(use_precond), p(X), p(hist), p(masks), p(delays), p(Pinv),
            p(edges.src), p(edges.dst), p(edges.R), p(edges.t), p(kw), p(tw),
            p(edges.pull), p(offsets), gamma, p(X_out), p(moved), p(work),
            ctypes.c_void_p(torch.cuda.current_stream(X.device).cuda_stream),
        )
    if rc != 0:
        raise RuntimeError(f"asapp_tick launch failed: cudaError {rc}")
    TICK_LAUNCHES += 1
    return X_out, moved


def asapp_tick_fused_ref(
    X: torch.Tensor,
    hist: torch.Tensor,
    masks: torch.Tensor,
    Pinv: torch.Tensor,
    edges: EdgeSet,
    delays: torch.Tensor,
    gamma: float,
    steps_per_tick: int,
    use_precond: bool,
    offsets: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K3 (the algebra of
    ``dpgo_ros_tpu/parallel/asapp.py::_tick_impl``), one robot after
    another; poses outside a robot's mask keep their stale values exactly
    through its steps, as in the kernel. ``offsets`` is not needed (the
    masks carry the blocks). Runs on any device."""
    Kp1 = hist.shape[0]
    n = X.shape[0]
    views = []
    for k, delay in enumerate(delays.tolist()):
        m = masks[k].reshape(n, 1, 1)
        Z = torch.where(m > 0, X, hist[delay % Kp1])
        for _ in range(steps_per_tick):
            g = m * stiefel.proj_tangent(Z, quadratic.egrad(Z, edges))
            if use_precond:
                g = m * stiefel.proj_tangent(Z, quadratic.precond_apply(Pinv, g))
            Z = torch.where(m > 0, stiefel.retract_polar_ns(Z, -gamma * g), Z)
        views.append(Z)
    m4 = masks[:, :, None, None]
    X_new = torch.sum(torch.stack(views) * m4, dim=0) + X * (1.0 - masks.sum(0)[:, None, None])
    per_pose2 = torch.sum((X_new - X) ** 2, dim=(-2, -1))
    return X_new, torch.sqrt(masks @ per_pose2)
