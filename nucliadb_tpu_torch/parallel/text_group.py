"""The keyword (BM25) legs of co-resident shards as one mesh program.

Counterpart of ``nucliadb_tpu/parallel/text_group.py``, the companion of
``parallel/group.py`` for the text half of a hybrid /find: the reference
runs every index leg inside its per-shard parallel fan-out
(nidx/src/searcher/shard_search.rs:211-273, shards_query.rs:29-72); here
every co-resident shard's BM25 scoring and top-k cut runs in one call over
the members of a 1-D ``shard`` mesh. The per-shard cuts come back to the
host (the product fuses every shard's hits with RRF, search/find.py).

Parity contract (the JAX package's): each member runs the SAME program as
a sequential ``DeviceTextEngine.search`` dispatch — ``bm25_groups`` (the
port's ``_bm25_groups_core``) over the shard's own group tensors, offsets,
planned slot rows and filter mask — in an unrolled member loop, so scores,
ids, matched-term counts and match totals are those of the per-shard path.
Host planning (term -> tier/row, masks, adaptive caps) stays per shard;
the group's caps are the elementwise max of the members' adaptive caps,
which never drops a term any member would have scheduled.

Eligibility is a layout condition: every member engine has the same
arena-group signature (per-group tier widths and dense presence). The JAX
package pads the members' tensors to one stacked shape for its one static
kernel; a member loop needs no common shape, so each member reads its
engine's own tensors (copied to its mesh device when that is another
one). The score space is the JAX package's: every member's n_pad and every
member's padded dense window ``offset_g + max n_pad of group g`` fits,
which is what keeps ``dynamic_slice``'s clamp off the wrong docs there.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..index.text_engine.engine import TextQuery
from ..ops import bm25
from ..utils.platform import device_fetch, stream_wait
from . import mesh as mesh_lib
from .mesh import Mesh, on_member
from .group import member_layout


def layout_sig(engine) -> tuple:
    """The kernel-shape signature a member contributes: per arena-group
    tier widths and dense-block presence."""
    return tuple((g.widths, g.dense_dev is not None) for g in engine.groups)


class MeshTextGroup:
    """The paragraph engines of N co-resident shards on a 1-D ``shard``
    mesh. Rebuilt (by the caller's cache) when a member shard reloads."""

    @staticmethod
    def eligible(psearchers: Sequence) -> bool:
        if not psearchers or any(p is None for p in psearchers):
            return False
        engines = [p.engine for p in psearchers]
        if any(e.n_docs == 0 for e in engines):
            return False
        return len({layout_sig(e) for e in engines}) == 1

    def __init__(self, psearchers: Sequence, mesh: Mesh | None = None):
        assert self.eligible(psearchers)
        self.searchers = list(psearchers)
        engines = [p.engine for p in psearchers]
        self.engines = engines
        self.mesh = mesh or Mesh(mesh_lib.visible_devices(engines[0].device), ("shard",))
        s = len(engines)
        self.n_shards = s
        self.shards_per_dev, self.s_pad = member_layout(s, self.mesh)
        sig = layout_sig(engines[0])
        self.tier_counts = tuple(len(w) for w, _ in sig)
        n_groups = len(sig)

        # score-space length: every member's n_pad AND every padded dense
        # window (offset_g + the group-max width of group g) fits
        gp_pad = [max(e.groups[gi].n_pad for e in engines) for gi in range(n_groups)]
        self.n_pad = max(
            max(e.n_pad for e in engines),
            max(int(e.group_offsets[gi]) + gp_pad[gi] for e in engines for gi in range(n_groups)),
        )

        self.devices = [self.mesh.devices[i // self.shards_per_dev] for i in range(s)]
        self.groups, self.offsets = [], []
        for e, dev in zip(engines, self.devices):
            with on_member(dev):
                self.groups.append(tuple(
                    (
                        tuple(tuple(t.to(dev) for t in tier) for tier in tiers),
                        None if dense is None else dense.to(dev),
                        dl.to(dev),
                    )
                    for tiers, dense, dl in e._group_tensors()
                ))
            self.offsets.append(e._offsets())
        # each member's kernel layout, once (the group is one refresh)
        self.layouts = [
            bm25.group_layout(g, o) if dev.type == "cuda" else None
            for g, o, dev in zip(self.groups, self.offsets, self.devices)
        ]
        for dev in set(self.devices):
            stream_wait(dev)

    def search(
        self, queries: "Sequence[Optional[TextQuery]]", top_k: int
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Score each member shard's query in one call.

        ``queries[i]`` is shard i's planned TextQuery (None: skip that
        shard, an empty prefilter). All come from ONE product request, so
        ``top_k`` and all_terms are uniform. Returns ([S, k] scores, [S, 2k]
        packed ids+counts, [S] match counts): what S sequential
        ``DeviceTextEngine.search`` count-only dispatches return."""
        assert len(queries) == self.n_shards
        k = min(top_k, self.n_pad)
        with_counts = any(q is not None and q.all_terms for q in queries)

        caps_list, plans = [], []
        for e, q in zip(self.engines, queries):
            if q is None:
                plans.append(None)
                continue
            terms, required = e._plan_terms(q)
            slots = e._plan_slots(terms)
            caps_list.append(e._caps_for(slots, adaptive=True))
            plans.append((e, q, slots, required))
        if not caps_list:
            raise ValueError("mesh text group search with no active shards")
        caps = tuple(max(c[i] for c in caps_list) for i in range(len(caps_list[0])))
        width = int(sum(caps))

        outs = []
        for i, plan in enumerate(plans):
            rows = np.full(width, -1, np.int32)
            idfs = np.zeros(width, np.float32)
            params = np.array([1.0, 0.0, 0.0], np.float32)  # avgdl placeholder of a skipped row
            mask = np.zeros(self.n_pad, bool)
            if plan is not None:
                e, q, slots, required = plan
                rows, idfs, scheduled = e._pack_slots(slots, caps)
                params = e._params_for(required, scheduled, q)
                m = e.build_mask(q)
                mask[: m.shape[0]] = m
            dev = self.devices[i]
            with on_member(dev):
                top_s, top_ic, matched = bm25.bm25_groups(
                    self.groups[i], self.offsets[i], torch.from_numpy(mask).to(dev),
                    torch.from_numpy(rows).to(dev), torch.from_numpy(idfs).to(dev),
                    torch.from_numpy(params).to(dev), k, caps, self.tier_counts, with_counts,
                    layout=self.layouts[i],
                )
                outs.append((top_s, top_ic, matched.sum().to(torch.int32)))
        first = self.mesh.first
        with on_member(first):
            top_s = torch.stack([o[0].to(first) for o in outs])
            top_ic = torch.stack([o[1].to(first) for o in outs])
            counts = torch.stack([o[2].to(first) for o in outs])
        return device_fetch(top_s, top_ic, counts)
