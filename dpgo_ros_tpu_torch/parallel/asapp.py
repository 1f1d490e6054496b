"""Asynchronous (ASAPP) mode: bounded-staleness parallel local stepping.

Port of ``dpgo_ros_tpu/parallel/asapp.py``: the reference's asynchronous
mode (``runOnceAsynchronous``, ``src/PGOAgentROS.cpp:119-127``; RGD solver
pick ``src/PGOAgentROSNode.cpp:87-93``; ``launch/asapp_demo.launch``) as
deterministic bounded staleness. A ring buffer holds the last K+1 global
states; at tick t robot k sees its own block fresh and every other pose
from slot δ_k(t) of the ring, δ_k(t) ~ U{0..K}, and runs ``steps_per_tick
= max(1, round(asynchronous_rate / 100))`` (preconditioned) RGD steps
(``RGD_stepsize``, decayed as γ₀·T₀/(T₀+t) when
``asapp_stepsize_decay_ticks`` = T₀ > 0). All robots update at once.
After the tick, slot ``t mod (K+1)`` receives the pre-tick state. The run
stops before the first tick at which every robot's per-tick movement is
below ``asapp_tolerance``.

Each tick is one call of ``fused_asapp.asapp_tick_fused``: one launch of
the CUDA kernel K3 on a CUDA device (float32 only; each robot on its
window, built once per engine), its plain version on the CPU; the ring
write is a copy on the same stream after it. The stop test stays on the
device, as in the JAX runner's ``lax.while_loop``: a ``live`` flag that K3
reads (a stopped tick leaves X and the movement as they are), the ring
write, the recorded movement row and a tick counter predicated on it; the
host reads the counter once per chunk and rewinds the delay generator to
the ticks that ran.

Delays come from a ``torch.Generator`` seeded with ``config.seed``, drawn
on the host as a (ticks, R) int table per chunk (``torch.randint`` tables
are prefix-consistent, so the stream does not depend on the chunking). It
gives other bits than the JAX package's ``jax.random`` stream from the same
seed, so the runners also take an explicit ``delays`` table (row t is used
at absolute tick t) — the parity tests hand in the JAX stream that way.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from dpgo_ros_tpu_torch.models.local_solvers import RGDParams
from dpgo_ros_tpu_torch.models.problem import LiftedProblem
from dpgo_ros_tpu_torch.ops import fused_asapp, hbm_rtr, quadratic
from dpgo_ros_tpu_torch.utils.config import AgentConfig


class ASAPPState(NamedTuple):
    X: torch.Tensor  # (n, r, d+1) current global state
    hist: torch.Tensor  # (K+1, n, r, d+1) ring buffer of past states
    tick: int
    rng: torch.Tensor  # state of the delay generator (torch.Generator.get_state)
    rel_change: torch.Tensor  # (R,) per-robot block-Frobenius movement/tick


class ASAPPEngine:
    """Bounded-staleness asynchronous PGO on the problem's device."""

    def __init__(self, problem: LiftedProblem, config: AgentConfig):
        self.problem = problem
        self.config = cfg = config.resolve()
        self.device = problem.device
        self.dtype = torch.float64 if cfg.dtype == "float64" else torch.float32
        if problem.dtype != self.dtype:
            raise ValueError(
                f"problem dtype {problem.dtype} != config dtype {cfg.dtype}"
            )
        if self.device.type == "cuda" and self.dtype != torch.float32:
            raise ValueError("the CUDA tick kernel is float32 only")
        self.K = int(cfg.max_delayed_iterations)
        self.rgd = RGDParams(
            stepsize=cfg.RGD_stepsize,
            use_preconditioner=cfg.RGD_use_preconditioner,
        )
        self.steps_per_tick = max(1, int(round(cfg.asynchronous_rate / 100.0)))
        rof = np.asarray(problem.robot_of_pose)
        self._masks = torch.tensor(
            np.stack([rof == k for k in range(problem.num_robots)]),
            dtype=self.dtype, device=self.device,
        )  # (R, n)
        self._offsets = torch.as_tensor(
            np.concatenate([problem.offsets, [problem.n]]),
            dtype=torch.int32, device=self.device,
        )
        # weights are fixed in async mode (no weight rounds), so the
        # block-Jacobi inverse is computed once per engine
        self._Pinv = quadratic.precond_inverse(
            quadratic.precond_blocks(problem.edges, problem.n)
        ).contiguous()

    @functools.cached_property
    def _windows(self) -> hbm_rtr.Windows:
        """Every robot's window (K3's tables), built on the first tick."""
        return hbm_rtr.prepare_windows(self.problem)

    def init_state(self, X0: torch.Tensor, seed: Optional[int] = None) -> ASAPPState:
        X0 = X0.to(dtype=self.dtype, device=self.device).contiguous()
        gen = torch.Generator().manual_seed(
            self.config.seed if seed is None else seed
        )
        return ASAPPState(
            X=X0,
            hist=X0.unsqueeze(0).repeat(self.K + 1, 1, 1, 1),
            tick=0,
            rng=gen.get_state(),
            rel_change=torch.full(
                (self.problem.num_robots,), float("inf"), dtype=self.dtype,
                device=self.device,
            ),
        )

    def stepsize_at(self, tick: int) -> float:
        """γ_t: constant, or γ₀·T₀/(T₀+t) when ``asapp_stepsize_decay_ticks``
        = T₀ > 0 (the O(1/t) decay that shrinks the bounded-staleness noise
        ball while Σγ_t = ∞ keeps global reach)."""
        T0 = float(self.config.asapp_stepsize_decay_ticks or 0)
        g0 = self.rgd.stepsize
        return g0 if T0 <= 0 else g0 * T0 / (T0 + tick)

    def _tick(self, X, hist, delays, tick: int, live=None, rel=None):
        """K3 (or its plain version) for absolute tick ``tick``."""
        return fused_asapp.asapp_tick_fused(
            X, hist, self._masks, self._Pinv, self.problem.edges, delays,
            self.stepsize_at(tick), self.steps_per_tick,
            self.rgd.use_preconditioner, self._offsets,
            windows=self._windows, live=live, rel=rel,
        )

    def tick(self, st: ASAPPState, delays: torch.Tensor) -> ASAPPState:
        """One tick with the given (R,) int32 delays on the engine's device:
        K3 (or its plain version), then the ring write of the pre-tick
        state, as its own copy after the tick. ``st.hist`` is updated in
        place; the runners hand in a copy of the caller's."""
        X_new, moved = self._tick(st.X, st.hist, delays, st.tick)
        st.hist[st.tick % (self.K + 1)].copy_(st.X)
        return st._replace(X=X_new, tick=st.tick + 1,
                           rel_change=moved.to(self.dtype))

    def _draw(self, gen: torch.Generator, ticks: int) -> torch.Tensor:
        return torch.randint(
            0, self.K + 1, (ticks, self.problem.num_robots), generator=gen
        )

    def make_fused_run(self, tol: float = 0.0, record_upto: int = 0):
        """Runner ``run(state, until_tick, rel_hist=None, delays=None)``:
        ticks until ``until_tick``, stopping before the first tick at which
        every robot's rel change is below ``tol`` (0 disables the stop).
        ``delays`` (T, R) ints, row t for absolute tick t, replaces the
        engine's generator. ``record_upto > 0`` records each tick's
        movement into ``rel_hist`` ((record_upto, R), NaN rows for ticks not
        run; a new one when None) and the runner returns ``(state,
        rel_hist)``.

        With ``tol > 0`` the stop is tested on the device (no host read per
        tick): ``live`` = not every rel change below tol, an int32 scalar
        carried from tick to tick; a tick after the stop is a no-op (K3
        copies X, the ring write and the recorded row keep their old
        values, the tick counter does not move). The host reads the counter
        at the end of the chunk and rewinds the generator to it."""
        R = self.problem.num_robots
        Kp1 = self.K + 1

        def run(st: ASAPPState, until_tick: int, rel_hist=None, delays=None):
            until = int(until_tick)
            ticks = max(until - st.tick, 0)
            gen = torch.Generator()
            gen.set_state(st.rng)
            if delays is not None:
                table = torch.as_tensor(delays)[st.tick:until]
                if table.shape != (ticks, R):
                    raise ValueError(
                        f"delays: rows {st.tick}..{until} of shape "
                        f"{tuple(torch.as_tensor(delays).shape)}"
                    )
            else:
                rng0 = gen.get_state()
                table = self._draw(gen, ticks)
            table = table.to(dtype=torch.int32, device=self.device)
            if record_upto and rel_hist is None:
                rel_hist = torch.full((record_upto, R), float("nan"),
                                      dtype=self.dtype, device=self.device)
            X, hist, rel = st.X, st.hist.clone(), st.rel_change
            live = count = None
            if tol > 0:
                live = (~(rel < tol).all()).to(torch.int32)
                count = torch.zeros((), dtype=torch.int32, device=self.device)
            for j in range(ticks):
                t = st.tick + j
                X_new, rel_new = self._tick(X, hist, table[j], t, live,
                                            None if live is None else rel)
                rel_new = rel_new.to(self.dtype)
                ring = hist[t % Kp1]
                if live is None:
                    ring.copy_(X)
                    if record_upto:
                        rel_hist[t] = rel_new
                else:
                    ring.copy_(torch.where(live > 0, X, ring))
                    if record_upto:
                        rel_hist[t] = torch.where(live > 0, rel_new, rel_hist[t])
                    count += live
                    live = live * (~(rel_new < tol).all()).to(torch.int32)
                X, rel = X_new, rel_new
            ran = ticks if count is None else int(count)  # one host read per chunk
            if ran < ticks and delays is None:  # the generator advances by the ticks run
                gen.set_state(rng0)
                self._draw(gen, ran)
            s = st._replace(X=X, hist=hist, tick=st.tick + ran, rng=gen.get_state(),
                            rel_change=rel)
            return (s, rel_hist) if record_upto else s

        return run

    def run(
        self,
        X0: Optional[torch.Tensor] = None,
        num_ticks: int = 1000,
        chunk: int = 200,
        tol: float = 0.0,
        state: Optional[ASAPPState] = None,
        record: bool = False,
        on_chunk=None,
        delays=None,
    ) -> Tuple[ASAPPState, dict]:
        """Up to ``num_ticks`` ticks (absolute) in chunks of ``chunk``, with
        the rel-change stop at ``tol``. Pass ``state`` to continue a run
        instead of ``X0``; ``record=True`` collects the per-tick per-robot
        rel change (``info["rel_hist"]``, rows of ticks run in this call);
        ``on_chunk(tick, state)`` fires after each chunk; ``delays`` as in
        :meth:`make_fused_run`. The info keys are the JAX engine's:
        ``costs`` (at the start and after each chunk), ``ticks``,
        ``ticks_this_run``, ``converged``, ``rel_change``, ``rel_hist``."""
        st = state if state is not None else self.init_state(X0)
        e = self.problem.edges
        costs = [float(quadratic.cost(st.X, e))]
        done = t_anchor = st.tick
        runner = self.make_fused_run(tol, record_upto=num_ticks if record else 0)
        hist = None
        while done < num_ticks:
            until = min(done + chunk, num_ticks)
            if record:
                st, hist = runner(st, until, hist, delays)
            else:
                st = runner(st, until, delays=delays)
            costs.append(float(quadratic.cost(st.X, e)))
            if on_chunk is not None:
                on_chunk(st.tick, st)
            done = st.tick
            if self._converged(st, tol):
                break
        info = {
            "costs": costs,
            "ticks": done,
            "ticks_this_run": done - t_anchor,
            "converged": self._converged(st, tol),
            "rel_change": st.rel_change.cpu().tolist(),
        }
        if record:
            h = (hist.cpu().numpy().astype(np.float64) if hist is not None
                 else np.zeros((0, self.problem.num_robots)))
            info["rel_hist"] = h[~np.all(np.isnan(h), axis=1)]
        return st, info

    @staticmethod
    def _converged(st: ASAPPState, tol: float) -> bool:
        return tol > 0 and bool(torch.all(st.rel_change < tol))
