"""Keyframe/point slot-recycling unit semantics for BOTH graph backends
(python `map_state.MapGraph` and the C++ `native.NativeMapGraph`).

The reference gets unbounded map growth from a shared_ptr heap
(`/root/reference/src/Map.cc:37-68`); the SoA index space here recycles
culled slots through an aged quarantine instead. These tests pin the
invariants that make that safe:
- dead slots become allocatable only after >= 3 subsequent KF creations,
- a recycled slot is scrubbed (spanning tree, loop edges, identity),
- kf_seq provides the temporal order that slot indices no longer do,
- kill_point is idempotent (no double-quarantine -> no double-allocation),
- young_points tracks recently created landmarks across recycling.
"""

import numpy as np
import pytest

from orb_slam2_refactored_tpu.native import NativeMapGraph
from orb_slam2_refactored_tpu.slam.map_state import MapCapacity, MapGraph

# the same two backends in every worker: the native one builds at first use
BACKENDS = [MapGraph, NativeMapGraph]


@pytest.mark.parametrize("cls", BACKENDS, ids=lambda c: c.__name__)
class TestKfSlotRecycling:
    def _full_graph(self, cls, n=4):
        g = cls(MapCapacity(max_keyframes=n, max_points=64, max_features=8))
        for s in [g.alloc_kf_slot() for _ in range(n)]:
            g.set_kf_alive(s, True)
        g.origin_kf = 0
        return g

    def test_quarantine_ages_before_reuse(self, cls):
        g = self._full_graph(cls)
        assert not g.can_alloc_kf()
        g.kill_keyframe(2)
        assert not g.can_alloc_kf(), "dead slot must age before reuse"
        g.num_kfs += 3  # simulate 3 subsequent creations
        assert g.can_alloc_kf()
        assert g.alloc_kf_slot() == 2

    def test_recycled_slot_is_scrubbed(self, cls):
        g = self._full_graph(cls)
        g.parent[2] = 1
        g.loop_edges.setdefault(2, set()).add(3)
        g.loop_edges.setdefault(3, set()).add(2)
        g.kf_frame_id[2] = 77
        g.kill_keyframe(2)
        g.num_kfs += 3
        s = g.alloc_kf_slot()
        assert s == 2
        assert g.parent[2] == -1
        assert 2 not in g.loop_edges.get(3, set())
        assert g.kf_frame_id[2] == -1
        assert (g.kf_row[2] == -1).all()

    def test_kf_seq_is_temporal_order(self, cls):
        g = self._full_graph(cls)
        seqs = [int(g.kf_seq[k]) for k in range(4)]
        assert seqs == [0, 1, 2, 3]
        g.kill_keyframe(1)
        g.num_kfs += 3
        s = g.alloc_kf_slot()
        assert s == 1
        # the NEW tenant of slot 1 is temporally NEWEST despite its index
        assert int(g.kf_seq[1]) > int(g.kf_seq[3])

    def test_origin_never_recycles(self, cls):
        g = self._full_graph(cls)
        g.kill_keyframe(0)  # origin: must be a no-op
        assert g.kf_alive[0]
        assert not any(k == 0 for k, _ in g.kf_quarantine)


@pytest.mark.parametrize("cls", BACKENDS, ids=lambda c: c.__name__)
class TestPointRecycling:
    def test_kill_point_idempotent(self, cls):
        g = cls(MapCapacity(max_keyframes=4, max_points=32, max_features=8))
        s = g.alloc_kf_slot()
        g.set_kf_alive(s, True)
        g.pt_alive[5] = True
        g.add_observation(5, s, 1, False)
        assert len(g.kill_point(5)) == 1
        assert g.kill_point(5) == []
        assert len([q for q in g.pt_quarantine if q[0] == 5]) == 1

    def test_young_points_across_recycling(self, cls):
        g = cls(MapCapacity(max_keyframes=8, max_points=32, max_features=8))
        s0 = g.alloc_kf_slot()
        g.set_kf_alive(s0, True)
        g.pt_alive[3] = True
        g.note_new_point(3, s0)
        assert g.young_points(int(g.kf_seq[s0]), 4) == [3]
        # kill it; young_points must drop it
        g.kill_point(3)
        assert g.young_points(int(g.kf_seq[s0]), 4) == []
        # recycle into a new landmark 5 creations later: only the NEW
        # entry (with the new seq) may be young
        for _ in range(5):
            k = g.alloc_kf_slot()
            g.set_kf_alive(k, True)
        g.pt_alive[3] = True
        g.note_new_point(3, k)
        young = g.young_points(int(g.kf_seq[k]), 4)
        assert young == [3]
