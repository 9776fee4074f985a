"""Multirate Runge-Kutta: a slow outer 2N low-storage scheme with fast
inner substeps (port of ``climatemachine_tpu/ode/multirate.py``
``MultirateRungeKutta`` :20-67).

Per slow stage s the accumulated slow tendency dQ_slow is held fixed as a
forcing of the fast solver, scaled by B_s/γ (γ the stage's fraction of
the step), while the fast solver advances γ·dt in substeps of at most its
own dt.
"""

from __future__ import annotations


class MultirateRungeKutta:
    """``slow`` and ``fast``: :class:`~climatemachine_tpu_torch.ode.lsrk.
    LowStorageRungeKutta2N` instances, of which the right-hand sides and
    tableaus are used; the fast solver's dt sets the substep target.
    ``step(q, aux, t) -> (q', aux')`` takes one slow step of ``dt``, which
    does not adapt (``dt_fixed``)."""

    def __init__(self, slow, fast, dt: float = None):
        self.slow = slow
        self.fast = fast
        self.dt = float(dt if dt is not None else slow.dt)
        self.dt_fixed = True

    def step(self, q, aux, t: float):
        slow, fast, dt = self.slow, self.fast, self.dt
        S = slow.nstages
        dqslow = None
        for s in range(S):
            t_stage = t + slow.C[s] * dt
            tend, aux = slow.rhs(q, aux, t_stage)
            dqslow = tend if dqslow is None else slow.A[s] * dqslow + tend
            gamma = (1.0 - slow.C[s]) if s == S - 1 else \
                (slow.C[s + 1] - slow.C[s])
            if gamma <= 0:
                continue
            nsub = max(int(-(-gamma * dt // fast.dt)), 1)
            fast_dt = gamma * dt / nsub
            forcing = (slow.B[s] / gamma) * dqslow
            tf = t_stage
            for _ in range(nsub):
                q, aux = self._fast_step(q, aux, tf, fast_dt, forcing)
                tf += fast_dt
        return q, aux

    def _fast_step(self, q, aux, t, fast_dt, forcing):
        """One fast 2N step with the constant slow forcing added to every
        stage tendency."""
        fast = self.fast
        dq = None
        for s in range(fast.nstages):
            tend, aux = fast.rhs(q, aux, t + fast.C[s] * fast_dt)
            tend = tend + forcing
            dq = tend if dq is None else fast.A[s] * dq + tend
            q = q + (fast.B[s] * fast_dt) * dq
        return q, aux
