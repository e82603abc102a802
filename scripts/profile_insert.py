"""Sub-stage breakdown of the map insert (chained timing, production
scale): sort -> unique compaction -> probe/lookup -> claim loop ->
compact-block gather -> policy rounds -> write-back scatter."""

import os, sys, time
import numpy as np
import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sage_icp_tpu.utils.compile_cache import configure_compile_cache  # noqa: E402

configure_compile_cache()
from sage_icp_tpu.models import pipeline as pl
from sage_icp_tpu.ops import correspondence_fast as cf
from sage_icp_tpu.ops import hashmap as hm
from sage_icp_tpu.ops import scan as scan_ops
from sage_icp_tpu.ops.scan import trunc_div
from sage_icp_tpu.utils import synthetic


def chain(name, fn, *args, n=50):
    @jax.jit
    def loop(*a):
        def body(i, acc):
            out = fn(a[0] + acc * 1e-30, *a[1:])
            leaf = jax.tree.leaves(out)[0]
            return acc + leaf.reshape(-1)[0].astype(jnp.float32) * 1e-30

        return jax.lax.fori_loop(0, n, body, jnp.float32(0.0))

    float(loop(*args))
    t0 = time.perf_counter()
    float(loop(*args))
    dt = (time.perf_counter() - t0) / n
    print(f"{name:52s} {dt*1e3:9.2f} ms", flush=True)
    return dt


def main():
    cfg = pl.SageConfig(dynamic_vehicle_filter=False, min_range=2.0)
    print("devices:", jax.devices(), flush=True)
    world_pts, world_labs = synthetic.build_world(seed=0, length=260.0)
    gt = synthetic.make_trajectory(12, step=1.0)
    rng = np.random.default_rng(0)
    odom = pl.SageICP(cfg)
    for i in range(10):
        odom.register_frame(synthetic.render_scan(
            world_pts, world_labs, gt[i], rng, n_target=120000))
    state = odom.state

    scan = synthetic.render_scan(world_pts, world_labs, gt[10], rng,
                                 n_target=120000)
    cap = cfg.scan_capacity
    buf = np.full((cap, 4), scan_ops.INVALID_COORD, dtype=np.float32)
    buf[: len(scan)] = scan
    val = np.zeros((cap,), dtype=bool)
    val[: len(scan)] = True
    lut = scan_ops.make_label_group_lut(list(map(list, cfg.voxel_labels)))
    sizes = jnp.asarray(cfg.voxel_size, dtype=jnp.float32)
    c, cv = jax.jit(lambda p, v: scan_ops.preprocess(
        p, v, cfg.max_range, cfg.min_range, cfg.label_max_range))(
            jnp.asarray(buf), jnp.asarray(val))
    points, valid = jax.jit(lambda p, v: scan_ops.voxel_downsample(
        p, v, lut, sizes, 0.5, cfg.frame_capacity))(c, cv)

    center = trunc_div(jnp.zeros(3), cfg.voxel_size_map)
    tables = jax.jit(lambda st: cf.build_probe_tables(
        st, center, cfg.probe_depth))(state.map)
    voxel_size = cfg.voxel_size_map
    U = min(cfg.insert_unique_capacity, cfg.frame_capacity)
    mapst = state.map
    capC = mapst.capacity
    kmax = mapst.points_per_voxel
    n = points.shape[0]
    basic_label_mask = pl._basic_label_mask(cfg)
    basic_points = cfg.basic_points_per_voxel
    probe_depth = cfg.probe_depth

    def s_sort(p):
        return hm._unique_voxels_of_points(p, valid, voxel_size)

    chain("sort + unique (65k)", lambda p: s_sort(p)[1], points)

    def s_compact(p):
        pts_sorted, vkeys, head, val_sorted = s_sort(p)
        head_valid = head & val_sorted
        pos = jnp.arange(n, dtype=jnp.int32)
        u_rank = jnp.cumsum(head_valid) - 1
        u_src = jnp.where(head_valid & (u_rank < U), u_rank, U)
        head_pos = jnp.full((U,), n, jnp.int32).at[u_src].set(
            pos, mode="drop", unique_indices=True)
        ukeys = jnp.zeros((U, 3), jnp.int32).at[u_src].set(
            vkeys, mode="drop", unique_indices=True)
        n_unique = jnp.sum(head_valid.astype(jnp.int32))
        u_live = jnp.arange(U, dtype=jnp.int32) < jnp.minimum(n_unique, U)
        pt_u = jnp.cumsum(head_valid) - 1
        seg_idx = jnp.where(val_sorted & (pt_u < U), pt_u, U)
        seg_len = jnp.zeros((U,), jnp.int32).at[seg_idx].add(
            1, mode="drop", indices_are_sorted=True)
        return pts_sorted, head_pos, ukeys, u_live, seg_len

    chain("+ unique compaction", lambda p: s_compact(p)[2], points)

    def s_probe(p):
        out = s_compact(p)
        ukeys, u_live = out[2], out[3]
        rel_u = ukeys - tables.center[None, :]
        found_u, slots_u = cf.probe(
            tables, ukeys, cf.pack_rel(rel_u), probe_depth)
        slot_u = jnp.where(u_live & found_u, slots_u, -1)
        return slot_u, out

    chain("+ probe lookup", lambda p: s_probe(p)[0], points)

    def s_claim(p):
        slot_u, out = s_probe(p)
        ukeys, u_live = out[2], out[3]
        need_claim = u_live & (slot_u < 0)
        h = hm.hash_keys(ukeys, capC)
        taken = mapst.counts > 0
        uid = jnp.arange(U, dtype=jnp.int32)

        def claim_round(d, carry):
            slot_u, taken = carry
            unresolved = need_claim & (slot_u < 0)
            s = (h + hm.probe_offset(d)) & (capC - 1)
            eligible = unresolved & ~taken[s]
            claim = jnp.full((capC,), jnp.iinfo(jnp.int32).max, jnp.int32)
            claim = claim.at[jnp.where(eligible, s, capC)].min(
                uid, mode="drop")
            won = eligible & (claim[s] == uid)
            slot_u = jnp.where(won, s, slot_u)
            taken = taken.at[jnp.where(won, s, capC)].set(
                True, mode="drop", unique_indices=True)
            return slot_u, taken

        slot_u, _ = jax.lax.fori_loop(0, probe_depth, claim_round,
                                      (slot_u, taken))
        return slot_u, out

    chain("+ claim loop", lambda p: s_claim(p)[0], points)

    def s_full(p):
        return hm.insert(mapst, p, valid, voxel_size, basic_points,
                         basic_label_mask, cfg.max_incoming_per_voxel,
                         probe_depth, U, tables)

    chain("FULL insert (rounds + write-back)", lambda p: s_full(p).counts,
          points, n=20)

    # write-back scatter alone, at the same shapes
    compact = jnp.asarray(
        np.random.default_rng(0).normal(size=(U, kmax * 4)).astype(np.float32))
    wslot = jnp.asarray(
        np.random.default_rng(1).permutation(capC)[:U].astype(np.int32))
    points2 = mapst.points.reshape(capC, kmax * 4)

    def s_wb(c2):
        return points2.at[wslot].set(c2, mode="drop", unique_indices=True)

    chain("write-back scatter alone (U=32k x 640B)", s_wb, compact, n=20)


if __name__ == "__main__":
    main()
