"""The accelerated block update's extrapolation (K7) as a hand-written CUDA
kernel, and its plain version.

An accelerated update (``parallel/rbcd.py``,
``RBCDEngine._accelerated_update``; JAX ``_block_update``) solves the block
against the auxiliary state V into Z, keeps the solved block over X as
X_acc, and extrapolates the block's V as Retr(X_acc, β·proj(X_acc,
mask·(X_acc − X_prev))) with the Newton–Schulz polar retraction
(``stiefel.retract_polar_ns``, :data:`NS_STEPS` steps); V keeps its other
poses. :func:`extrapolate` returns (X_acc, V_new) from one launch of
``csrc/nesterov_extrapolate.cu`` for CUDA tensors, and raises if the kernel
cannot be built or launched; for CPU tensors it runs the plain version
:func:`extrapolate_ref`, the selects around ``stiefel.proj_tangent`` and
``stiefel.retract_polar_ns`` as the JAX package writes the step. No path
falls back from one to the other.

On the card the operand checks run once per layout (each operand's device,
dtype, shape and strides), not on every call; β is read by the kernel from
the device, so the θ-sequence's β = (θ − 1)/θ' needs no host read. Counter:
``k7.launches`` per CUDA launch.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

from dpgo_ros_tpu_torch.ops import fused_rtr, stiefel
from dpgo_ros_tpu_torch.utils import profiling

NS_STEPS = 20  # the kernel's Newton–Schulz steps, retract_polar_ns's default
_checked: set = set()  # operand layouts that passed check_operands


def extrapolate(
    Z: torch.Tensor,
    X: torch.Tensor,
    X_prev: torch.Tensor,
    V: torch.Tensor,
    mask: torch.Tensor,
    beta: Union[float, torch.Tensor],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(X_acc, V_new) of one accelerated block update.

    Z (n, r, d+1): V with the block solved; X, X_prev, V (n, r, d+1) the
    state; ``mask`` (n,) the update's per-pose mask (a robot's row or a
    colour's); ``beta`` the extrapolation weight. On the card every operand
    is contiguous float32 on X's card and ``beta`` a one-element tensor
    there; on the CPU ``beta`` may also be a float."""
    if X.device.type == "cpu":
        return extrapolate_ref(Z, X, X_prev, V, mask, beta)
    if not isinstance(beta, torch.Tensor):
        raise TypeError("extrapolate: on the card beta is a one-element tensor")
    ops = (Z, X, X_prev, V, mask, beta)
    key = tuple((t.device, t.dtype, t.shape, t.stride()) for t in ops)
    if key not in _checked:
        if X.device.type != "cuda":
            raise ValueError(f"extrapolate: unsupported device {X.device}")
        check_operands("extrapolate", *ops)
        _checked.add(key)
    n, r, dp1 = X.shape
    card = X.device.index
    X_acc, V_new = torch.empty_like(X), torch.empty_like(V)
    rc = fused_rtr._library(fused_rtr.EXTRAP_SOURCE).dpgo_nesterov_extrapolate(
        card, dp1 - 1, r, n, Z.data_ptr(), X.data_ptr(), X_prev.data_ptr(),
        V.data_ptr(), mask.data_ptr(), beta.data_ptr(), X_acc.data_ptr(),
        V_new.data_ptr(), torch._C._cuda_getCurrentRawStream(card))
    fused_rtr.check_launch("nesterov_extrapolate", rc)
    profiling.count("k7.launches")  # the CUDA kernel's (not the plain version's)
    return X_acc, V_new


def check_operands(who, Z, X, X_prev, V, mask, beta) -> None:
    """Raise on operands the kernel cannot take: shapes, ranks the kernel
    is built for, devices other than X's, dtypes other than float32,
    layouts that are not contiguous."""
    if not isinstance(beta, torch.Tensor):
        raise TypeError(f"{who}: beta must be a one-element tensor")
    if X.dim() != 3:
        raise ValueError(f"{who}: X shape {tuple(X.shape)}, expected (n, r, d+1)")
    n, r, dp1 = X.shape
    if dp1 - 1 not in (2, 3):
        raise ValueError(f"{who}: d={dp1 - 1} (kernel takes 2 or 3)")
    if not 1 <= r <= fused_rtr.MAX_RANK:
        raise ValueError(f"{who}: r={r} (kernel takes 1..{fused_rtr.MAX_RANK})")
    if n < 1:
        raise ValueError(f"{who}: no poses")
    for name, ten in (("Z", Z), ("X_prev", X_prev), ("V", V)):
        if ten.shape != X.shape:
            raise ValueError(f"{who}: {name} shape {tuple(ten.shape)}, X {tuple(X.shape)}")
    if mask.shape != (n,):
        raise ValueError(f"{who}: mask shape {tuple(mask.shape)}, expected ({n},)")
    if beta.numel() != 1:
        raise ValueError(f"{who}: beta has {beta.numel()} elements, expected 1")
    for name, ten in (("Z", Z), ("X", X), ("X_prev", X_prev), ("V", V),
                      ("mask", mask), ("beta", beta)):
        if ten.device != X.device:
            raise ValueError(f"{who}: {name} on {ten.device}, X on {X.device}")
        if ten.dtype != torch.float32:
            raise TypeError(f"{who}: {name} is {ten.dtype}, expected torch.float32")
        if not ten.is_contiguous():
            raise ValueError(f"{who}: {name} is not contiguous")


def extrapolate_ref(Z, X, X_prev, V, mask, beta) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K7 on any device: the select of X_acc, the tangent
    projection, the Newton–Schulz retraction over every pose and the select
    of V, as separate PyTorch ops."""
    m = mask.reshape(-1, 1, 1)
    X_acc = torch.where(m > 0, Z, X)
    Vk = stiefel.retract_polar_ns(
        X_acc, beta * stiefel.proj_tangent(X_acc, m * (X_acc - X_prev)), NS_STEPS)
    return X_acc, torch.where(m > 0, Vk, V)
