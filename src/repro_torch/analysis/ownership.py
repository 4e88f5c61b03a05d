"""Slab write ownership: the port of the reference's
``check_write_ownership`` (:mod:`repro.analysis.jaxpr_lint`), a numeric
probe of the sequence-parallel decode's write routing.

Each shard of a sequence group holds its stripe of every request's pages
(``PagedLayout.slot_owner``/``slot_local``), and every shard runs the
same decode step. A new token's K/V must land on the one shard that owns
its logical slot, on that shard's page of the slot
(``serve/engine.sharded_write_target``); every other shard, and every
inactive row on any shard, must route the write to the null page 0 (a
page no request reads). A write that lands elsewhere overwrites another
request's or another position's K/V, silently.

The probe runs every cache position from 0 past one ring wrap (``n_sink
+ ring_cap + 5`` rows, every fourth row inactive) through each shard's
routing, with page tables whose entries are all distinct (so a wrong page
is seen), and checks the unsharded twin ``PagedLayout.write_target`` with
``keep=active`` the same way. CPU only: the routing is integer tensor
arithmetic, the same on either device.
"""
from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch.analysis import Finding

MAX_REPORTED = 4        # findings a kind of fault reports per shard


def check_write_ownership(lay, target: str = "",
                          write_target: Optional[Callable] = None
                          ) -> List[Finding]:
    """Probe the decode write routing of the layout ``lay`` over every
    cache position and shard: a shard writes its owned slot's page at the
    slot's offset, or the null page 0, never another shard's storage and
    never an inactive row's page. ``write_target``: the sharded routing
    under test (``serve.engine.sharded_write_target`` by default)."""
    if write_target is None:
        from repro_torch.serve.engine import sharded_write_target
        write_target = sharded_write_target
    findings: List[Finding] = []
    npp_s = lay.pages_per_shard
    T = lay.n_sink + lay.ring_cap + 5
    t_vec = torch.arange(T, dtype=torch.int32)
    active_np = (np.arange(T) % 4) != 3            # live and dead rows
    active = torch.from_numpy(active_np)
    table_np = 1 + np.arange(T * npp_s).reshape(T, npp_s)
    owner = lay.slot_owner(lay.slot(t_vec)).numpy()
    for idx in range(lay.shards):
        own_table = table_np + idx * T * npp_s
        _, local_slot, phys, off = (a.numpy() for a in write_target(
            lay, torch.from_numpy(own_table.astype(np.int32)), t_vec,
            active, idx))
        owned = active_np & (owner == idx)
        for r in np.nonzero(~owned & (phys != 0))[0][:MAX_REPORTED]:
            findings.append(Finding(
                "write-ownership", target,
                f"shard {idx} writes physical page {int(phys[r])} for "
                f"position {r} it does not own (owner {int(owner[r])}, "
                f"active={bool(active_np[r])}) — non-owner writes must "
                f"route to null page 0"))
        rows = np.nonzero(owned)[0]
        want = own_table[rows, local_slot[rows] // lay.page]
        bad = (phys[rows] != want) | (off[rows] != local_slot[rows]
                                      % lay.page)
        for r, w in list(zip(rows[bad], want[bad]))[:MAX_REPORTED]:
            findings.append(Finding(
                "write-ownership", target,
                f"shard {idx} position {r}: write lands on page "
                f"{int(phys[r])} offset {int(off[r])}, expected its own "
                f"page {int(w)} offset {int(local_slot[r]) % lay.page}"))

    # the unsharded twin: inactive rows must hit the null page
    table = torch.from_numpy((1 + np.arange(T * lay.pages_per_req)).reshape(
        T, lay.pages_per_req).astype(np.int32))
    phys, _ = (a.numpy() for a in lay.write_target(table, t_vec,
                                                   keep=active))
    for r in np.nonzero((phys != 0) & ~active_np)[0][:1]:
        findings.append(Finding(
            "write-ownership", target,
            f"inactive row {r} writes physical page {int(phys[r])}, "
            f"expected null page 0"))
    return findings
