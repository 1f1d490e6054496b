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

On the card the operand checks run in full only when an operand's layout
(device, dtype, shape, strides) or the mask's tensor differs from the last
call's that passed (:func:`checked`); β is read by the kernel from the
device, so the θ-sequence's β = (θ − 1)/θ' needs no host read. Counter:
``k7.launches`` per CUDA launch.
"""

from __future__ import annotations

from ctypes import c_int, c_void_p
from typing import Tuple, Union

import torch

from dpgo_ros_tpu_torch.ops import kernels, stiefel
from dpgo_ros_tpu_torch.utils import profiling

NS_STEPS = 20  # the kernel's Newton–Schulz steps, retract_polar_ns's default
# K7's C entry (csrc/nesterov_extrapolate.cu), as kernels.load declares it
ENTRIES = {"dpgo_nesterov_extrapolate": ([c_int] * 4 + [c_void_p] * 9, c_int)}
_kept: dict = {}  # "k7": the (key, held) whose checks last passed (kernels.hit)


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
    if X.device.type != "cuda":
        raise ValueError(f"extrapolate: unsupported device {X.device}")
    checked(Z, X, X_prev, V, mask, beta)
    n, r, dp1 = X.shape
    card = X.device.index
    X_acc, V_new = torch.empty_like(X), torch.empty_like(V)
    rc = kernels.load(kernels.EXTRAP_SOURCE, ENTRIES).dpgo_nesterov_extrapolate(
        card, dp1 - 1, r, n, Z.data_ptr(), X.data_ptr(), X_prev.data_ptr(),
        V.data_ptr(), mask.data_ptr(), beta.data_ptr(), X_acc.data_ptr(),
        V_new.data_ptr(), kernels.stream(card))
    kernels.check_launch("nesterov_extrapolate", rc)
    profiling.count("k7.launches")  # the CUDA kernel's (not the plain version's)
    return X_acc, V_new


def checked(Z, X, X_prev, V, mask, beta) -> None:
    """The card's operand checks (:func:`check_operands`), rerun only when
    an operand's layout or the tensor the mask row views has changed (not
    its row: the checks read no value)."""
    key, held = kernels.guard((Z, X, X_prev, V, mask, beta),
                              (mask if mask._base is None else mask._base,))
    if not kernels.hit(_kept.get("k7"), key):
        check_operands("extrapolate", Z, X, X_prev, V, mask, beta)
        _kept["k7"] = key, held


def check_operands(who, Z, X, X_prev, V, mask, beta) -> None:
    """Raise on operands the kernel cannot take: shapes, ranks the kernel
    is built for, devices other than X's, dtypes other than float32,
    layouts that are not contiguous."""
    if not isinstance(beta, torch.Tensor):
        raise TypeError(f"{who}: beta must be a one-element tensor")
    kernels.check_pose_shape(who, X)
    n = X.shape[0]
    if n < 1:
        raise ValueError(f"{who}: no poses")
    for name, ten in (("Z", Z), ("X_prev", X_prev), ("V", V)):
        if ten.shape != X.shape:
            raise ValueError(f"{who}: {name} shape {tuple(ten.shape)}, X {tuple(X.shape)}")
    if mask.shape != (n,):
        raise ValueError(f"{who}: mask shape {tuple(mask.shape)}, expected ({n},)")
    if beta.numel() != 1:
        raise ValueError(f"{who}: beta has {beta.numel()} elements, expected 1")
    kernels.check_tensors(who, X, {"Z": Z, "X": X, "X_prev": X_prev, "V": V,
                                   "mask": mask, "beta": beta}, torch.float32)


def extrapolate_ref(Z, X, X_prev, V, mask, beta) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K7 on any device: the select of X_acc, the tangent
    projection, the Newton–Schulz retraction over every pose and the select
    of V, as separate PyTorch ops."""
    m = mask.reshape(-1, 1, 1)
    X_acc = torch.where(m > 0, Z, X)
    Vk = stiefel.retract_polar_ns(
        X_acc, beta * stiefel.proj_tangent(X_acc, m * (X_acc - X_prev)), NS_STEPS)
    return X_acc, torch.where(m > 0, Vk, V)
