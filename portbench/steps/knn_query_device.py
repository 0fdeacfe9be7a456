"""Step kind ``knn_query_device``: build ``kdtree.KDTree`` from the device
points, then ``.query_device`` on its self-queries, tensors in and out.

Traffic keys: ``k``, ``queries`` (the first that many points are the
queries), ``leafsize``, ``set_seeds``: the two input sets are drawn from
these seeds, the same in every run, as the upstream harness draws its one
set, and the run's seed only orders them (the queries among themselves,
the other points among themselves). So every seed gives the same work:
whether a query reaches the exact ladder depends on the points, and a
step with one such query costs several milliseconds more than a step with
none. Configuration keys: ``box`` and what the generator reads
(``points``).

Check: the outputs of two steps drawn from the seed and of each input set's
last step are held to the plain reference (``reference/knn.py``, float64)
over every query. ``dist_err``: the largest gap between a returned distance
and the reference's at the same rank; ``index_err``: the largest gap
between the reference's distance to the returned index and the reference's
distance at that rank; both over the median k-th reference distance.
"""
from __future__ import annotations

import numpy as np
import torch

from nbodyhpc_tpu_torch.kdtree import KDTree
from nbodyhpc_tpu_torch.ops import knn_device
from portbench.harness import step_seed, sync
from portbench.reference import knn as ref

DRAWN = 2      # steps kept besides each set's last, drawn from the first
DRAWN_FROM = 8


def rank_errors(d, i, d_ref, pts, q, box: float):
    """(dist_err, index_err) of one answer against the reference."""
    d_ref = d_ref.to(pts.device, torch.float64)
    scale = float(d_ref[:, -1].median())
    d = d.to(torch.float64)
    dist_err = float((d - d_ref).abs().max()) / scale
    i = i.long()
    n = pts.shape[0]
    if bool(((i < 0) | (i >= n)).any()):
        return dist_err, float("inf")
    p64 = pts.to(torch.float64)
    di = ref.min_image_d2(p64[i], q.to(torch.float64)[:, None, :], box).sqrt()
    return dist_err, float((di - d_ref).abs().max()) / scale


def plant_fault(kind: str) -> None:
    """Break the query this step kind drives (``harness.FAULTS``), in this
    loaded copy of the module only: ``altered``, one row's k-th index off;
    ``half``, half of the queries left out, their rows zero."""
    global KDTree
    base = KDTree

    class Tree(base):
        def query_device(self, q, k=1, engine="auto"):
            if kind == "half":
                n = q.shape[0] // 2
                d, i = super().query_device(q[:n], k, engine)
                return (torch.cat([d, torch.zeros_like(d)]),
                        torch.cat([i, torch.zeros_like(i)]))
            d, i = super().query_device(q, k, engine)
            i[0, -1] = (i[0, -1] + 1) % self.n
            return d, i

    KDTree = Tree


class Step:
    unit = "queries"

    def __init__(self, config, traffic, generator, seed, device):
        self.counter = knn_device.query_blocks_device
        self.device = device
        self.k = int(traffic["k"])
        self.nq = int(traffic["queries"])
        self.leafsize = int(traffic["leafsize"])
        self.box = float(config["box"])
        self.sets = [self._ordered(generator.make(config, "points", int(b),
                                                  device), step_seed(seed, s))
                     for s, b in enumerate(traffic["set_seeds"])]
        rng = np.random.Generator(np.random.Philox(step_seed(seed, 3)))
        self.drawn = set(int(v) for v in
                         rng.choice(DRAWN_FROM, DRAWN, replace=False))
        self.kept, self.last, self.ladder = [], {}, 0

    def _ordered(self, pts, seed: int):
        """``pts`` reordered from ``seed``: the first ``nq`` among
        themselves, the rest among themselves."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        n, nq = pts.shape[0], self.nq
        order = torch.cat([
            torch.randperm(nq, generator=gen, device=self.device),
            nq + torch.randperm(n - nq, generator=gen, device=self.device)])
        return pts[order]

    def params(self) -> dict:
        return {"points": int(self.sets[0].shape[0]), "queries": self.nq,
                "k": self.k}

    def run(self, i: int) -> int:
        pts = self.sets[i % 2]
        with torch.profiler.record_function("portbench.knn.build"):
            tree = KDTree(pts, leafsize=self.leafsize, boxsize=self.box)
            sync(self.device)
        with torch.profiler.record_function("portbench.knn.query"):
            d, idx = tree.query_device(pts[:self.nq], k=self.k)
            sync(self.device)
        self.ladder = self.counter.ladder_queries
        if i in self.drawn:
            self.kept.append((i % 2, d, idx))
        self.last[i % 2] = (i % 2, d, idx)
        return self.nq

    def warm(self) -> None:
        for i in range(2):
            self.run(i)
        self.kept.clear()
        self.last.clear()

    def counters(self) -> dict:
        return {"queries": self.nq, "ladder_queries": self.ladder}

    def check(self, limits, control=None):
        """([(name, value, limit)], steps failed). ``control``: a dtype in
        which the reference stands in for the program."""
        kept = self.kept + list(self.last.values())
        refs = {}
        for s in sorted({s for s, _, _ in kept} | ({0, 1} if control else set())):
            pts = self.sets[s]
            refs[s] = ref.knn(pts, pts[:self.nq], self.k, self.box)[0]
        if control is not None:
            kept = []
            for s in range(2):
                pts = self.sets[s]
                d, i = ref.knn(pts, pts[:self.nq], self.k, self.box,
                               dtype=control)
                kept.append((s, d.float(), i))
        worst = [0.0, 0.0]
        failed = 0
        for s, d, i in kept:
            pts = self.sets[s]
            e = rank_errors(d, i, refs[s], pts, pts[:self.nq], self.box)
            e = [v if v == v else float("inf") for v in e]
            failed += not (e[0] <= limits["dist_err"]
                           and e[1] <= limits["index_err"])
            worst = [max(a, b) for a, b in zip(worst, e)]
        if not kept:
            worst = [float("inf")] * 2
        return [("dist_err", worst[0], limits["dist_err"]),
                ("index_err", worst[1], limits["index_err"])], failed
