"""Online registration: ``register_pair`` one pair at a time, in a closed
loop of one client.

Request k takes pool pair k (cycling) as raw clouds: ``prepare_cloud`` for
both, ``register_pair`` with draws of its own, made on the card from
(seed, k) as the request begins, then one read of the pose and counts to
the host. A request's latency runs from its start, the prepare included,
to that read. The work of a request: one pair through every scale.
"""

from __future__ import annotations

import time

from benchmark.entries.common import Record, make_draws, read_results
from benchmark.seeding import random_state

__all__ = ["Entry"]


class Entry:
    def __init__(self, env):
        self.env = env
        p = env.traffic["entry_params"]
        self.warm_calls = int(p["warm_calls"])
        self.trace_calls = int(p["trace_calls"])
        self.check_requests = int(p["check_requests"])
        self.stage_requests = int(p["stage_requests"])
        self.calls = 0

    def draws_of(self, k: int) -> tuple:
        """The draws of request ``k``."""
        return make_draws(self.env, "single", k, None)

    def clouds(self, i: int) -> tuple:
        env, reg = self.env, self.env.reg
        return (reg.prepare_cloud(env.pool[i][0], env.cfg, seed=2 * i,
                                  device=env.device),
                reg.prepare_cloud(env.pool[i][1], env.cfg, seed=2 * i + 1,
                                  device=env.device))

    def call(self) -> list:
        """One request of the window: [Record]."""
        env, reg = self.env, self.env.reg
        k = self.calls
        self.calls += 1
        i = k % len(env.pool)
        t0 = time.perf_counter()
        with env.span("bench.prepare"):
            src, tgt = self.clouds(i)
        with env.span("bench.register"):
            res = reg.register_pair(
                env.cfg, src, tgt, env.models,
                draws=reg.Draws(*self.draws_of(k)), device=env.device)
        with env.span("bench.read"):
            host = read_results([res])[0]
        return [Record(pair=i, call=k, batch=0, slot=0,
                       latency_s=time.perf_counter() - t0, **host)]

    def warm(self) -> None:
        for _ in range(self.warm_calls):
            self.call()
        self.calls = 0

    def passes(self, records: list) -> list:
        """[(pairs, scales)]: a pair through every scale a request."""
        scales = tuple(range(self.env.statics["num_scales"]))
        return [(1, scales) for _r in records]

    def check_groups(self, records: list) -> list:
        """``check_requests`` requests of the window drawn from the seed
        (every request runs every scale: all are the longest).
        [(kind, pair indices, draws, records)]."""
        rs = random_state(self.env.seed, "check.requests")
        pick = sorted(rs.choice(len(records),
                                min(len(records), self.check_requests),
                                replace=False))
        return [("single", [records[j].pair],
                 self.draws_of(records[j].call),
                 [records[j]]) for j in pick]

    def stages(self) -> dict:
        """Mean ms of ``register_pair_timed``'s fenced phases over the first
        ``stage_requests`` pool pairs: {"desc": ..., "pose": ...}."""
        env, reg = self.env, self.env.reg
        sums = {"desc_time": 0.0, "pose_time": 0.0}
        n = min(self.stage_requests, len(env.pool))
        for i in range(n):
            src, tgt = self.clouds(i)
            _res, phases = reg.register_pair_timed(
                env.cfg, src, tgt, env.models,
                draws=reg.Draws(*self.draws_of(i)),
                device=env.device)
            for key in sums:
                sums[key] += phases[key]
        return {"desc": sums["desc_time"] / n * 1e3,
                "pose": sums["pose_time"] / n * 1e3}
