"""The two lint passes of ``repro_torch.analysis`` that have no plan to
prove, on the CPU.

* Slab write ownership (``analysis.ownership``): the sequence-parallel
  decode's write routing is clean on every registry layout, at 1 and 2
  shards, as the reference's ``check_write_ownership`` finds its own
  routing on the reference's layouts; a planted routing fault (each
  shard routing as its neighbour) is flagged, every finding of the port
  one of the reference's on the same fault, and so are a routing that
  ignores ownership and an unsharded twin that writes inactive rows.
* The shared-memory budget (``analysis.smem_budget``): the mirror gives
  the sizes the ``.cu`` sources state in their comments (K1's f32 block
  at hd 256, K2's 2-warp and K3's 4-warp blocks at hd 256), the launchers'
  choice of warps, no finding for any registry target at hd 64-256 in
  f32/bf16/f16 or any decode instantiation, an error finding for an
  oversized launch, and the owner sum's row cap: the largest sequence
  length a target's packed plan fits is exact (one key tile more does
  not fit).

The exports of the ``.cu`` files are held to the mirror on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``'s analysis phase).
"""
import pytest
import torch

from repro_torch.analysis import smem_budget as S
from repro_torch.analysis.ownership import check_write_ownership
from repro_torch.analysis.registry import ownership_targets, plan_targets
from repro_torch.serve.engine import sharded_write_target
from repro_torch.serve.paged_cache import layout_for_pattern


def _layout(t):
    return layout_for_pattern(t.pattern, t.page, shards=t.shards)


# ------------------------------------------------------------------ #
# write ownership
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("i", range(len(ownership_targets())))
def test_write_routing_is_clean_on_every_layout(i):
    t = ownership_targets()[i]
    lay = _layout(t)
    assert lay.shards == t.shards
    assert check_write_ownership(lay, t.name) == []


@pytest.mark.parametrize("shards", [1, 2])
def test_reference_probe_agrees_on_its_layouts(shards):
    """The reference's probe of its own routing at the reference's
    layouts finds nothing either."""
    from repro.analysis.jaxpr_lint import check_write_ownership as jcheck
    from repro.core import patterns as JP
    from repro.serve.paged_cache import layout_for_pattern as jlayout

    jlay = jlayout(JP.causal_sliding_window(16, n_sinks=2), 8, shards=shards)
    assert jcheck(jlay, "t") == []


def test_a_planted_routing_fault_is_flagged(monkeypatch):
    """Each shard routing its writes as its neighbour would: positions it
    does not own land on pages, its own positions on the null page. The
    port flags it, and each of its findings is one the reference's probe
    gives on the same fault."""
    from repro.analysis.jaxpr_lint import check_write_ownership as jcheck
    from repro.core import patterns as JP
    from repro.serve import engine as JE
    from repro.serve.paged_cache import layout_for_pattern as jlayout

    def flipped(lay, pt, t, active, idx):
        return sharded_write_target(lay, pt, t, active, (idx + 1) % 2)

    t = [x for x in ownership_targets() if x.name == "paged_layout@2shards"]
    got = check_write_ownership(_layout(t[0]), "t", flipped)
    assert any("does not own" in f.message for f in got)
    assert any("expected its own page" in f.message for f in got)
    real = JE.sharded_write_target
    monkeypatch.setattr(JE, "sharded_write_target",
                        lambda lay, pt, tv, a, idx: real(lay, pt, tv, a,
                                                         (idx + 1) % 2))
    want = {f.message for f in jcheck(jlayout(
        JP.causal_sliding_window(16, n_sinks=2), 8, shards=2), "t")}
    assert {f.message for f in got} <= want


def test_a_routing_that_ignores_ownership_is_flagged():
    """Every active row written on every shard (ownership not checked):
    the shards overwrite each other's pages."""
    def everyone(lay, pt, t, active, idx):
        keep, local, phys, off = sharded_write_target(lay, pt, t, active,
                                                      idx)
        slot = lay.slot_local(lay.slot(t))
        phys = torch.gather(pt, 1, (slot // lay.page)[:, None].long())[:, 0]
        return keep, local, torch.where(active, phys, 0).int(), off

    t = ownership_targets()[2]
    got = check_write_ownership(_layout(t), t.name, everyone)
    assert got and all("does not own" in f.message for f in got)


def test_an_inactive_row_written_by_the_unsharded_twin_is_flagged(
        monkeypatch):
    lay = _layout(ownership_targets()[0])
    real = type(lay).write_target
    monkeypatch.setattr(type(lay), "write_target",
                        lambda self, pt, p, keep=None: real(self, pt, p))
    got = check_write_ownership(lay, "t")
    assert len(got) == 1 and "inactive row 3" in got[0].message


# ------------------------------------------------------------------ #
# the shared-memory budget
# ------------------------------------------------------------------ #
def test_mirror_pins_the_sizes_the_sources_state():
    assert S.k1_bytes(256) == 223_488          # salo_table_attention.cu
    assert S.k2_bytes(256, 2) == 189_976       # salo_table_backward.cu
    assert S.k3_bytes(256, 4) == 211_256
    # the launchers' warps: 2 at hd 256 for K2, at most 4 for K3, else by
    # the block (32 -> 2, 64 -> 4, 128 and 256 -> 8)
    ls = {x.kernel: x for x in S.table_launches("bfloat16", 256, 128, 128)}
    assert (ls["K1"].nw, ls["K2"].nw, ls["K3"].nw) == (8, 2, 4)
    assert ls["K2"].dynamic == 189_976 and ls["K3"].dynamic == 211_256
    ls = {x.kernel: x for x in S.table_launches("float16", 64, 32, 64)}
    assert (ls["K1"].nw, ls["K2"].nw, ls["K3"].nw) == (2, 2, 4)
    ls = {x.kernel: x for x in S.table_launches("float32", 128, 128, 128)}
    assert all(x.nw == 0 for x in ls.values())
    # the decode body's static arrays as ptxas lays them out for sm_90a
    # (the build's "bytes smem"): an fp cache's kernels drop the unused V
    # scales; and the owner sum's one int takes 16 bytes
    for (dtype, kv, hd), want in {
            ("bfloat16", "bfloat16", 64): 42_036,
            ("bfloat16", "bfloat16", 128): 41_268,
            ("float16", "float16", 256): 37_556,
            ("float32", "float32", 256): 39_284,
            ("bfloat16", "int8", 64): 26_164,
            ("float32", "int8", 128): 44_084,
            ("float32", "int8", 256): 44_596}.items():
        assert S.decode_bytes(dtype, kv, hd) == want, (dtype, kv, hd)
    assert S.OWNER_SUM_STATIC == 16
    # every instantiation of the sources, each size once
    inst = S.instantiations()
    assert len({(x.kernel, x.dtype, x.hd, x.nw, x.kv) for x in inst}) \
        == len(inst)
    assert all(x.total <= x.limit for x in inst)


def test_every_target_and_decode_instantiation_fits():
    findings, rows = S.check_budget(plan_targets(), with_max_n=False)
    assert findings == []
    assert [r["target"] for r in rows] == [f"smem[{t.name}]"
                                           for t in plan_targets()]
    assert max(r["largest_bytes"] for r in rows) == S.k1_bytes(256)


def test_an_oversized_launch_is_flagged():
    big = S.Launch("K1", "bfloat16", 512, 8, S.k1_bytes(512, 8))
    got = S.check_launches([big, S.Launch("K2", "bfloat16", 256, 2,
                                          S.k2_bytes(256, 2))], "t")
    assert len(got) == 1 and "K1[bfloat16, hd 512, 8 warps]" in \
        got[0].message and "opt-in" in got[0].message
    cap = S.owner_sum_rows_cap()
    owner = [x for x in S.table_launches("float32", 64, 32, 32, cap + 1)
             if x.kernel == "K3-owner-sum"]
    got = S.check_launches(owner, "t")
    assert len(got) == 1 and "default limit" in got[0].message
    assert S.check_launches([x for x in S.table_launches(
        "float32", 64, 32, 32, cap) if x.kernel == "K3-owner-sum"], "t") \
        == []


@pytest.mark.parametrize("name", ["longformer", "causal-sw-sinks"])
def test_owner_sum_cap_is_exact(name):
    """At the largest sequence length the budget reports, the packed
    plan's rows fit the owner sum; one key tile more, they do not."""
    from repro_torch.core.scheduler import schedule

    t = [x for x in plan_targets() if x.name == name][0]
    bq, bk = S.target_blocks(t)
    n = S.max_owner_sum_n(t.pattern, bq, bk)
    assert n % bk == 0

    def rows(m):
        return schedule(t.pattern, m).plan(bq, bk).transposed_packed(
            ).n_rows
    assert rows(n) <= S.owner_sum_rows_cap() < rows(n + bk)
