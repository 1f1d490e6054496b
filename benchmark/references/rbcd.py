"""The plain reference of the RBCD configurations (``benchmark/reference.py``:
RoundRobin RBCD with RTR blocks, L2 or GNC-TLS, in float64), the one a
configuration has when its file names none: its declaration and hooks.

A reference module declares the numbers it reads (``NUMBERS``, each
compared against a limit above 0; ``EXACT``, counts whose limit is 0)
and provides the hooks that give them, as ``compare.py``, ``harness.py``
and ``control.py`` call them:

* ``lifting_matrix(seed, r, d)``: the lift of a graph's initial state
  (required);
* ``solve(g, solver, ylift, control=False, device=)``: a whole solve
  (``traj``, ``cost``; the control in the control's precision);
* ``follow(g, solver, ylift, stages, device=)``: a robust solve judged
  stage by stage (``init``, ``round_weights``, ``stretch``,
  ``stretch_cost``);
* ``state_cost(g, solver, X, w)`` and ``rounded(X)``: a final state read
  again (``state_cost``, ``rounding``);
* ``Schedule(solver, R)`` with ``gaps(rels, rounds_at, iterations)``:
  the round and stop rule replayed (``schedule``);
* ``settle_gaps(g, solver, T, w_round, w_final)`` (``settle``).

A module that lacks a hook leaves its numbers unread.
"""

from benchmark.reference import (  # noqa: F401
    Schedule,
    follow,
    lifting_matrix,
    rounded,
    settle_gaps,
    solve,
    state_cost,
)

NUMBERS = ("traj", "cost", "state_cost", "rounding", "init", "round_weights", "stretch",
           "stretch_cost")
EXACT = ("schedule", "settle")
