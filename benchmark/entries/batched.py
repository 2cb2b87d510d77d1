"""Batched two-phase serving: ``register_pairs_batched`` in a closed loop.

Call k takes the next ``pairs_per_call`` pairs of the pool, cycling, as raw
clouds: ``prepare_cloud`` for each (the host's shuffle and pad, the copy to
the card), then one ``register_pairs_batched`` call in batches of
``batch_size``, then one read of the call's poses and counts to the host.
Batch j of call k takes draws of its own (phase 1 and phase 2), made on
the card from (seed, k, j) as the call begins, so that no two batches of a
window share them.

The work of a call, as the counts read it: every batch through scale 0,
and the batch's redone pairs (``scales_used`` > 1) through every scale.
"""

from __future__ import annotations

from benchmark.entries.common import Record, make_draws, read_results
from benchmark.seeding import random_state

__all__ = ["Entry"]


class Entry:
    def __init__(self, env):
        self.env = env
        p = env.traffic["entry_params"]
        self.per_call = int(p["pairs_per_call"])
        self.batch = int(p["batch_size"])
        self.warm_calls = int(p["warm_calls"])
        self.trace_calls = int(p["trace_calls"])
        self.check_batches = int(p["check_batches"])
        self.batches_per_call = -(-self.per_call // self.batch)
        self.calls = 0

    def pairs_of(self, k: int) -> list:
        n = len(self.env.pool)
        return [(k * self.per_call + j) % n for j in range(self.per_call)]

    def draws_of(self, call: int, batch: int) -> tuple:
        """The (phase-1, phase-2) draws of batch ``batch`` of call ``call``."""
        index = call * self.batches_per_call + batch
        return (make_draws(self.env, "phase1", index, self.batch),
                make_draws(self.env, "phase2", index, self.batch))

    def batches_of(self, idx: list) -> list:
        return [idx[i:i + self.batch] for i in range(0, len(idx), self.batch)]

    def call(self) -> list:
        """One call of the window: [Record] of its pairs, in order."""
        env, reg = self.env, self.env.reg
        k = self.calls
        self.calls += 1
        idx = self.pairs_of(k)
        with env.span("bench.prepare"):
            srcs = [reg.prepare_cloud(env.pool[i][0], env.cfg, seed=2 * i,
                                      device=env.device) for i in idx]
            tgts = [reg.prepare_cloud(env.pool[i][1], env.cfg,
                                      seed=2 * i + 1, device=env.device)
                    for i in idx]
        batches = self.batches_of(idx)
        draws = [tuple(reg.Draws(*d) for d in self.draws_of(k, j))
                 for j in range(len(batches))]
        with env.span("bench.register"):
            res = reg.register_pairs_batched(
                env.cfg, srcs, tgts, env.models, batch_size=self.batch,
                draws=draws, device=env.device)
        with env.span("bench.read"):
            host = read_results(res)
        return [Record(pair=i, call=k, batch=j // self.batch,
                       slot=j % self.batch, **host[j])
                for j, i in enumerate(idx)]

    def warm(self) -> None:
        for _ in range(self.warm_calls):
            self.call()
        self.calls = 0

    def passes(self, records: list) -> list:
        """[(pairs, scales)] of the pipeline passes behind ``records``."""
        out = []
        groups: dict = {}
        for r in records:
            groups.setdefault((r.call, r.batch), []).append(r)
        n_scales = self.env.statics["num_scales"]
        for key in sorted(groups):
            batch = groups[key]
            out.append((len(batch), (0,)))
            redo = sum(r.scales_used > 1 for r in batch)
            if redo:
                out.append((redo, tuple(range(n_scales))))
        return out

    def check_groups(self, records: list) -> list:
        """The batches the reference runs again: the window's batch with the
        most redone pairs (the longest requests), and ``check_batches`` - 1
        more drawn from the seed. [(kind, pair indices, draws, records)]."""
        groups: dict = {}
        for r in records:
            groups.setdefault((r.call, r.batch), []).append(r)
        keys = sorted(groups)
        longest = max(keys, key=lambda key: (
            sum(r.scales_used > 1 for r in groups[key]), -keys.index(key)))
        rest = [key for key in keys if key != longest]
        rs = random_state(self.env.seed, "check.batches")
        pick = [longest] + [rest[i] for i in sorted(rs.choice(
            len(rest), min(len(rest), self.check_batches - 1),
            replace=False))]
        out = []
        for key in pick:
            batch = groups[key]
            out.append(("two_phase", [r.pair for r in batch],
                        self.draws_of(*key), batch))
        return out
