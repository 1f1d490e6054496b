"""One asynchronous (ASAPP) tick as a hand-written CUDA kernel (K3).

Port of ``dpgo_ros_tpu/ops/fused_asapp.py::asapp_tick_fused`` (the Pallas
kernel built by ``_make_asapp_kernel``). One tick updates every robot at
once: robot k sees its own block of X fresh and every other pose from the
ring-buffer slot ``delays[k] mod (K+1)``, runs ``steps_per_tick``
(preconditioned) Riemannian-gradient steps with the Newton–Schulz
retraction on its block, and the new state takes each robot's block from
its own view. On the card each robot's tick is one thread-block cluster on
the robot's window (``hbm_rtr.prepare_windows``: its block, the edges that
touch it, the separators at their far ends), all robots in one launch. The
kernel source ``csrc/asapp_tick.cu`` says what bounds it and how it is
laid out; it is built with the package's other kernels by
``fused_rtr.build_all()``.

:func:`asapp_tick_fused` launches K3 for CUDA tensors (the windows are
then required) and raises if it cannot be built or launched; for CPU
tensors it runs the plain version :func:`asapp_tick_fused_ref`
(full-width, the same function). No path falls back from one to the
other. :func:`asapp_tick_window_ref` is the plain tick on the windows.

A run's stop test can stay on the device: with ``live`` (an int32 scalar
tensor) a tick whose flag is 0 returns X unchanged and the movement
``rel`` it was given, so a runner needs no host read per tick.

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

from dpgo_ros_tpu_torch.ops import fused_rtr, hbm_rtr, quadratic, stiefel
from dpgo_ros_tpu_torch.ops.quadratic import EdgeSet
from dpgo_ros_tpu_torch.utils import profiling


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
    *,
    windows=None,
    live: Optional[torch.Tensor] = None,
    rel: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One ASAPP tick of every robot (K3).

    X (n, r, d+1); hist (K+1, n, r, d+1) ring buffer; masks (R, n), robot
    k's mask 1 on its block ``[offsets[k], offsets[k+1])`` and 0 elsewhere;
    Pinv (n, d+1, d+1) the damped block-Jacobi inverse; delays (R,) int32
    stale slots (taken mod K+1); gamma the stepsize of this tick; offsets
    (R+1,) int32 robot block bounds covering [0, n); ``windows`` the
    robots' windows (``hbm_rtr.prepare_windows`` of the same problem:
    required on the card, checked without a host read wherever given);
    ``live`` an int32 scalar stop flag and ``rel`` (R,) the movement to
    keep when it is 0 (both or neither).

    Returns (X_new, moved (R,)): moved_k = ‖(X_new − X)·mask_k‖_F; where
    ``live`` is 0, (X, rel).
    """
    if X.device.type not in ("cpu", "cuda"):
        raise ValueError(f"asapp_tick_fused: unsupported device {X.device}")
    on_card = X.device.type == "cuda"
    fdt = torch.float32 if on_card else X.dtype
    kw, tw = _checked(X, hist, masks, Pinv, edges, delays, offsets, fdt)
    _check_stop(X, masks, live, rel, fdt)
    if on_card or windows is not None:
        _check_windows(X, masks, edges, windows)
    if not on_card:
        X_new, moved = asapp_tick_fused_ref(X, hist, masks, Pinv, edges, delays, gamma,
                                            steps_per_tick, use_precond, offsets)
        if live is None:
            return X_new, moved
        return torch.where(live > 0, X_new, X), torch.where(live > 0, moved, rel)
    return _launch(X, hist, Pinv, edges, delays, float(gamma), int(steps_per_tick),
                   bool(use_precond), kw, tw, windows, live, rel)


def _check_stop(X, masks, live, rel, fdt) -> None:
    who = "asapp_tick_fused"
    if (live is None) != (rel is None):
        raise ValueError(f"{who}: pass live and rel together")
    if live is None:
        return
    if live.shape != () or live.dtype != torch.int32 or live.device != X.device:
        raise TypeError(f"{who}: live must be an int32 scalar on {X.device}")
    if rel.shape != (masks.shape[0],) or rel.dtype != fdt or rel.device != X.device:
        raise TypeError(f"{who}: rel must be ({masks.shape[0]},) {fdt} on {X.device}")
    if not rel.is_contiguous():
        raise ValueError(f"{who}: rel is not contiguous")


def _check_windows(X, masks, edges, windows) -> None:
    """Raise unless ``windows`` are the robots' windows of this world, on
    X's device, their blocks covering every pose (no host read)."""
    who = "asapp_tick_fused"
    if windows is None:
        raise ValueError(
            f"{who}: the kernel ticks each robot on its window: pass "
            "windows=hbm_rtr.prepare_windows(problem)")
    R = masks.shape[0]
    if windows.rows != tuple((k,) for k in range(R)):
        raise ValueError(f"{who}: the windows are not the {R} robots' own")
    windows.check(who, X, edges)
    if int(windows.num_poses.sum()) != X.shape[0]:
        raise ValueError(f"{who}: the windows' blocks do not cover the {X.shape[0]} poses")


def _launch(X, hist, Pinv, edges, delays, gamma, steps, use_precond, kw, tw,
            windows, live, rel):
    n, r, dp1 = X.shape
    d = dp1 - 1
    R = windows.num_rows
    nc, P = windows.cluster, windows.slice_max
    lib = fused_rtr._library(fused_rtr.TICK_SOURCE)
    ws = lib.dpgo_asapp_tick_workspace_floats(
        d, r, windows.max_poses, windows.max_edges, nc, P, R)
    X_out = torch.empty_like(X)  # the robots' blocks cover every pose
    moved = torch.empty(R, dtype=torch.float32, device=X.device)
    work = torch.empty(ws, dtype=torch.float32, device=X.device)
    p = lambda t: ctypes.c_void_p(t.data_ptr() if t is not None else None)
    with torch.cuda.device(X.device):  # launch on X's card, in its stream
        rc = lib.dpgo_asapp_tick(
            d, r, n, int(windows.pull.shape[1]), R, nc, P, windows.max_poses,
            windows.max_edges, int(hist.shape[0]), steps, int(use_precond),
            p(X), p(hist), p(delays), p(Pinv), p(edges.R), p(edges.t), p(kw), p(tw),
            p(windows.meta), p(windows.poses), p(windows.edges), p(windows.src),
            p(windows.dst), p(windows.pull), p(windows.part), p(live), p(rel),
            gamma, p(X_out), p(moved), p(work),
            ctypes.c_void_p(torch.cuda.current_stream(X.device).cuda_stream),
        )
    fused_rtr.check_launch("asapp_tick", rc, nc)
    profiling.count("k3.launches")  # the CUDA kernel's (not the plain version's)
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


def asapp_tick_window_ref(
    X: torch.Tensor,
    hist: torch.Tensor,
    Pinv: torch.Tensor,
    edges: EdgeSet,
    delays: torch.Tensor,
    gamma: float,
    steps_per_tick: int,
    use_precond: bool,
    windows,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K3's windowed tick: each robot's steps on
    its window (``hbm_rtr.prepare_windows``) — its block from X, its
    separators from its stale slot, the window's edges — then its block
    into X_new. The same function as :func:`asapp_tick_fused_ref`; the
    gradient's sums run over the window's pull rows, in global edge order.
    Runs on any device."""
    Kp1 = hist.shape[0]
    X_new = X.clone()
    moved = []
    for k, delay in enumerate(delays.tolist()):
        nb = int(windows.num_poses[k])
        pl = windows.window(k)[0].long()
        local = hbm_rtr.window_edges(edges, windows, k)
        m = torch.zeros((pl.shape[0], 1, 1), dtype=X.dtype, device=X.device)
        m[:nb] = 1.0
        Z = torch.cat([X[pl[:nb]], hist[delay % Kp1][pl[nb:]]])
        for _ in range(steps_per_tick):
            g = m * stiefel.proj_tangent(Z, quadratic.egrad(Z, local))
            if use_precond:
                g = m * stiefel.proj_tangent(Z, quadratic.precond_apply(Pinv[pl], g))
            Z = torch.where(m > 0, stiefel.retract_polar_ns(Z, -gamma * g), Z)
        X_new[pl[:nb]] = Z[:nb]
        moved.append(torch.sqrt(((Z[:nb] - X[pl[:nb]]) ** 2).sum()))
    return X_new, torch.stack(moved)
