"""Build, bind and launch the port's hand-written CUDA kernels.

The sources under csrc/ have a plain C interface.  At first use they are
compiled for Hopper (``nvcc -gencode arch=compute_90a,code=sm_90a``), one
``nvcc -c`` per source started together, linked into one shared library
under ``build/torch_kernels/`` at the repository root, and loaded with
ctypes.  Every launch goes on the current CUDA stream, neither
synchronises nor allocates inside the C function, and raises here when
the C function returns a CUDA error.  The wrappers allocate outputs with
``torch.empty`` and check device, dtype, shape and contiguity.

`LAUNCHES` counts kernel launches per kernel (plain ints): each wrapper
adds one exactly where it launches its kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
SOURCES = ("row_topk.cu", "assign_pass.cu", "commit_moves.cu",
           "leader_assign.cu", "commit_leadership.cu", "sweep_pick.cu",
           "forced_select.cu", "rank_accept.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES = {"row_topk": 0, "assign_pass": 0, "commit_moves": 0,
            "leader_assign_pass": 0, "commit_leadership": 0, "sweep_pick": 0,
            "forced_select": 0, "rank_accept": 0}

_LOCK = threading.Lock()
_LIB = None
#: {"seconds": build wall time, "log": nvcc's output, "path": the .so}
BUILD_INFO: dict = {}

_P = ctypes.c_void_p
_I = ctypes.c_int


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels of "
                       "cruise_control_tpu_torch need the CUDA toolkit")


def build() -> ctypes.CDLL:
    """Compile (once per source content) and load the kernel library."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        t0 = time.time()
        digest = hashlib.sha256()
        for name in SOURCES:
            digest.update((CSRC / name).read_bytes())
        digest.update(" ".join(NVCC_FLAGS).encode())
        tag = digest.hexdigest()[:16]
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        so = BUILD_DIR / f"libcc_kernels_{tag}.so"
        log = []
        if not so.exists():
            nvcc = _nvcc()
            procs = []
            objs = []
            for name in SOURCES:
                obj = BUILD_DIR / f"{Path(name).stem}_{tag}.o"
                objs.append(obj)
                procs.append((name, subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o",
                     str(obj)], stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT, text=True)))
            failed = []
            for name, proc in procs:
                out, _ = proc.communicate()
                log.append(f"== nvcc {name}\n{out}")
                if proc.returncode != 0:
                    failed.append(name)
            if failed:
                raise RuntimeError("nvcc failed for " + ", ".join(failed)
                                   + "\n" + "\n".join(log))
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            link = subprocess.run(
                [nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                 "-shared", "-o", str(tmp), *map(str, objs)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            log.append(f"== link\n{link.stdout}")
            if link.returncode != 0:
                raise RuntimeError("nvcc link failed\n" + "\n".join(log))
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        lib.cc_row_topk.argtypes = [_P, _P, _I, _I, _I, _P, _P, _P, _P, _P]
        lib.cc_assign_pass.argtypes = [_P, _P, _P, _P, _I, _I, _I, _P, _P,
                                       _P, _P]
        lib.cc_commit_moves.argtypes = [_I] * 7 + [_P] * 31 + [_P]
        lib.cc_leader_assign_pass.argtypes = [_P] * 8 + [_I] * 3 + [
            _P, _I, _I] + [_P] * 5
        lib.cc_commit_leadership.argtypes = [_I] * 4 + [_P] * 19
        lib.cc_sweep_pick.argtypes = [_I, _I] + [_P] * 14 + [
            ctypes.c_float, _I] + [_P] * 4
        lib.cc_forced_select.argtypes = [_I] * 4 + [_P] * 14 + [_P]
        lib.cc_rank_accept.argtypes = [_I] * 3 + [_P] * 13 + [_P]
        lib.cc_rank_accept_level_floats.argtypes = [_I]
        lib.cc_rank_accept_level_floats.restype = ctypes.c_longlong
        for fn in (lib.cc_row_topk, lib.cc_assign_pass, lib.cc_commit_moves,
                   lib.cc_leader_assign_pass, lib.cc_commit_leadership,
                   lib.cc_sweep_pick, lib.cc_forced_select,
                   lib.cc_rank_accept):
            fn.restype = ctypes.c_int
        BUILD_INFO.update(seconds=time.time() - t0, log="\n".join(log),
                          path=str(so))
        _LIB = lib
        return lib


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _check(t: torch.Tensor, name: str, dtype, shape=None) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed: error {err} "
                           f"({torch.cuda.get_device_name()})")


def row_topk(sc_rows: torch.Tensor, table: torch.Tensor, k: int):
    """K1 launch: (cand i32[B*k], has bool[B*k], top f32[B, k], slot
    i32[B, k])."""
    lib = build()
    b, s = sc_rows.shape
    if not 1 <= k <= min(64, s):
        raise ValueError(f"row_topk takes 1 <= k <= min(64, S), got k={k}")
    _check(sc_rows, "sc_rows", torch.float32)
    _check(table, "table", torch.int32, (b, s))
    cand = torch.empty(b * k, dtype=torch.int32, device=sc_rows.device)
    has = torch.empty(b * k, dtype=torch.bool, device=sc_rows.device)
    top = torch.empty((b, k), dtype=torch.float32, device=sc_rows.device)
    slot = torch.empty((b, k), dtype=torch.int32, device=sc_rows.device)
    err = lib.cc_row_topk(sc_rows.data_ptr(), table.data_ptr(), b, s, k,
                          cand.data_ptr(), has.data_ptr(), top.data_ptr(),
                          slot.data_ptr(), _stream())
    LAUNCHES["row_topk"] += 1
    _raise_on(err, "row_topk")
    return cand, has, top, slot


def assign_pass(pref: torch.Tensor, dest_open: torch.Tensor,
                assigned: torch.Tensor, cand_has: torch.Tensor, k: int,
                amp: torch.Tensor):
    """K2 launch: (best_slot i32[C], has bool[C])."""
    lib = build()
    c, kk = pref.shape
    _check(pref, "pref", torch.float32)
    _check(dest_open, "dest_open", torch.bool, (kk,))
    _check(assigned, "assigned", torch.bool, (c,))
    _check(cand_has, "cand_has", torch.bool, (c,))
    _check(amp, "amp", torch.float32, ())
    best = torch.empty(c, dtype=torch.int32, device=pref.device)
    has = torch.empty(c, dtype=torch.bool, device=pref.device)
    err = lib.cc_assign_pass(pref.data_ptr(), dest_open.data_ptr(),
                             assigned.data_ptr(), cand_has.data_ptr(), c, kk,
                             int(k), amp.data_ptr(), best.data_ptr(),
                             has.data_ptr(), _stream())
    LAUNCHES["assign_pass"] += 1
    _raise_on(err, "assign_pass")
    return best, has


#: the cache fields K3 writes in both modes, and with a broker table
AGGREGATE_FIELDS = ("broker_load", "replica_count", "leader_count",
                    "partition_rack_count", "broker_topic_count",
                    "potential_nw_out", "leader_bytes_in")
TABLE_FIELDS = ("broker_table", "table_fill", "table_load", "table_bonus",
                "table_leader", "table_ok")


def commit_fields(cache) -> tuple:
    """The cache fields K3 writes for `cache` (`commit_moves` hands the
    kernel copies of them): the aggregates, and the table planes when the
    cache carries a table."""
    if cache.broker_table.shape[1]:
        return AGGREGATE_FIELDS + TABLE_FIELDS
    return AGGREGATE_FIELDS


def commit_moves(state_before, cache, r: torch.Tensor, dst: torch.Tensor,
                 valid: torch.Tensor, rank) -> dict:
    """K3: the cache fields after committing the batch (fresh tensors; the
    inputs are not modified).  Without a broker table (table-less mode)
    the aggregates only, and `rank` may be None."""
    out = {f: getattr(cache, f).clone() for f in commit_fields(cache)}
    out["broker_util"] = torch.empty_like(cache.broker_load)
    commit_moves_into(out, state_before, cache, r, dst, valid, rank)
    return out


def commit_moves_into(out: dict, state_before, cache, r: torch.Tensor,
                      dst: torch.Tensor, valid: torch.Tensor,
                      rank) -> None:
    """K3 launch into `out`, which holds a copy of each of the cache's
    `commit_fields` (updated in place) and a `broker_util` plane
    (written); with a table, `cache.table_fill` is read as the fill
    before the batch."""
    lib = build()
    n = r.shape[0]
    num_b = state_before.num_brokers
    num_r = state_before.num_replicas
    sw = cache.broker_table.shape[1]
    if sw:
        _check(rank, "rank", torch.int32, (n,))
    for name, t, dt, shape in (
            ("r", r, torch.int32, (n,)), ("dst", dst, torch.int32, (n,)),
            ("valid", valid, torch.bool, (n,)),
            ("replica_broker", state_before.replica_broker, torch.int32,
             (num_r,)),
            ("replica_partition", state_before.replica_partition,
             torch.int32, (num_r,)),
            ("replica_is_leader", state_before.replica_is_leader,
             torch.bool, (num_r,)),
            ("replica_base_load", state_before.replica_base_load,
             torch.float32, (num_r, 4)),
            ("partition_leader_bonus", state_before.partition_leader_bonus,
             torch.float32, (state_before.num_partitions, 4)),
            ("partition_topic", state_before.partition_topic, torch.int32,
             None),
            ("broker_rack", state_before.broker_rack, torch.int32,
             (num_b,)),
            ("broker_capacity", state_before.broker_capacity, torch.float32,
             (num_b, 4)),
            ("replica_load", cache.replica_load, torch.float32, (num_r, 4)),
            ("replica_ok", cache.replica_ok, torch.bool, None),
            ("broker_load", cache.broker_load, torch.float32, (num_b, 4)),
            ("replica_count", cache.replica_count, torch.int32, (num_b,)),
            ("leader_count", cache.leader_count, torch.int32, (num_b,)),
            ("partition_rack_count", cache.partition_rack_count,
             torch.int32, None),
            ("broker_topic_count", cache.broker_topic_count, torch.int32,
             None),
            ("potential_nw_out", cache.potential_nw_out, torch.float32,
             (num_b,)),
            ("leader_bytes_in", cache.leader_bytes_in, torch.float32,
             (num_b,)),
            ("broker_table", cache.broker_table, torch.int32, (num_b, sw)),
            ("table_fill", cache.table_fill, torch.int32, (num_b,)),
            ("table_load", cache.table_load, torch.float32, (num_b, sw, 4)),
            ("table_bonus", cache.table_bonus, torch.float32,
             (num_b, sw, 4)),
            ("table_leader", cache.table_leader, torch.bool, (num_b, sw)),
            ("table_ok", cache.table_ok, torch.bool, (num_b, sw))):
        _check(t, name, dt, shape)
    for f in (*commit_fields(cache), "broker_util"):
        like = cache.broker_load if f == "broker_util" else getattr(cache, f)
        _check(out[f], f"out[{f!r}]", like.dtype, like.shape)
    if sw:
        # the kernel reads the fill before the batch while it counts
        # arrivals
        if out["table_fill"].data_ptr() == cache.table_fill.data_ptr():
            raise ValueError("out['table_fill'] must be a copy of the "
                             "cache's")
        table = {f: out[f] for f in TABLE_FIELDS}
    else:
        # table-less mode: the kernel touches no table plane
        table = {f: None for f in TABLE_FIELDS}

    def ptr(t):
        return None if t is None else t.data_ptr()
    # per-move scratch: the float contribution row and the two ends
    contrib = torch.empty((n, 8), dtype=torch.float32, device=r.device)
    ends = torch.empty((2, n), dtype=torch.int32, device=r.device)
    s = state_before
    err = lib.cc_commit_moves(
        n, num_b, sw, num_r, s.num_racks, s.num_topics,
        cache.replica_ok.shape[0],
        r.data_ptr(), dst.data_ptr(), valid.data_ptr(), ptr(rank),
        s.replica_broker.data_ptr(), s.replica_partition.data_ptr(),
        s.replica_is_leader.data_ptr(), s.replica_base_load.data_ptr(),
        s.partition_leader_bonus.data_ptr(), s.partition_topic.data_ptr(),
        s.broker_rack.data_ptr(), s.broker_capacity.data_ptr(),
        cache.replica_load.data_ptr(), cache.replica_ok.data_ptr(),
        out["broker_load"].data_ptr(), out["broker_util"].data_ptr(),
        out["replica_count"].data_ptr(), out["leader_count"].data_ptr(),
        out["partition_rack_count"].data_ptr(),
        out["broker_topic_count"].data_ptr(),
        out["potential_nw_out"].data_ptr(),
        out["leader_bytes_in"].data_ptr(), ptr(table["broker_table"]),
        cache.table_fill.data_ptr() if sw else None,
        ptr(table["table_fill"]), ptr(table["table_load"]),
        ptr(table["table_bonus"]), ptr(table["table_leader"]),
        ptr(table["table_ok"]),
        contrib.data_ptr(), ends.data_ptr(), _stream())
    LAUNCHES["commit_moves"] += 1
    _raise_on(err, "commit_moves")


def leader_assign_pass(pref: torch.Tensor, sib_broker: torch.Tensor,
                       sib_replica: torch.Tensor, src_broker: torch.Tensor,
                       taken_cnt: torch.Tensor, dep_cnt: torch.Tensor,
                       assigned: torch.Tensor, cand_has: torch.Tensor,
                       k: int, amp: torch.Tensor, multi: bool):
    """K4 launch: (slot i32[C], dest broker i32[C], promoted replica
    i32[C], has bool[C])."""
    from cruise_control_tpu_torch.analyzer.kernels import \
        MAX_ARRIVALS_PER_ROUND
    lib = build()
    c, rf = pref.shape
    _check(pref, "pref", torch.float32)
    _check(sib_broker, "sib_broker", torch.int32, (c, rf))
    _check(sib_replica, "sib_replica", torch.int32, (c, rf))
    _check(src_broker, "src_broker", torch.int32, (c,))
    _check(taken_cnt, "taken_cnt", torch.int32)
    _check(dep_cnt, "dep_cnt", torch.int32, taken_cnt.shape)
    _check(assigned, "assigned", torch.bool, (c,))
    _check(cand_has, "cand_has", torch.bool, (c,))
    _check(amp, "amp", torch.float32, ())
    outs = [torch.empty(c, dtype=torch.int32, device=pref.device)
            for _ in range(3)]
    has = torch.empty(c, dtype=torch.bool, device=pref.device)
    err = lib.cc_leader_assign_pass(
        pref.data_ptr(), sib_broker.data_ptr(), sib_replica.data_ptr(),
        src_broker.data_ptr(), taken_cnt.data_ptr(), dep_cnt.data_ptr(),
        assigned.data_ptr(), cand_has.data_ptr(), c, rf, int(k),
        amp.data_ptr(), int(bool(multi)), MAX_ARRIVALS_PER_ROUND,
        outs[0].data_ptr(), outs[1].data_ptr(), outs[2].data_ptr(),
        has.data_ptr(), _stream())
    LAUNCHES["leader_assign_pass"] += 1
    _raise_on(err, "leader_assign_pass")
    return outs[0], outs[1], outs[2], has


def commit_leadership(state_before, cache, sr: torch.Tensor,
                      dr: torch.Tensor, valid: torch.Tensor,
                      donate: bool = False) -> dict:
    """K5: the cache fields after a leadership-transfer batch.  With
    `donate` the kernel updates the cache's own planes in place (the
    caller gives the cache up); otherwise it writes into copies."""
    from cruise_control_tpu_torch.analyzer.context import LEADERSHIP_FIELDS
    sw = cache.broker_table.shape[1]
    fields = [f for f in LEADERSHIP_FIELDS if f != "broker_util"
              and (sw or not f.startswith("table_"))]
    if donate:
        out = {f: getattr(cache, f) for f in fields}
    else:
        out = {f: getattr(cache, f).clone() for f in fields}
    out["broker_util"] = torch.empty_like(cache.broker_load)
    commit_leadership_into(out, state_before, cache, sr, dr, valid)
    return out


def commit_leadership_into(out: dict, state_before, cache, sr: torch.Tensor,
                           dr: torch.Tensor, valid: torch.Tensor) -> None:
    """K5 launch into `out` (planes updated in place, `broker_util`
    written); `cache` supplies the broker table."""
    lib = build()
    n = sr.shape[0]
    num_b = state_before.num_brokers
    num_r = state_before.num_replicas
    sw = cache.broker_table.shape[1]
    s = state_before
    for name, t, dt, shape in (
            ("sr", sr, torch.int32, (n,)), ("dr", dr, torch.int32, (n,)),
            ("valid", valid, torch.bool, (n,)),
            ("replica_broker", s.replica_broker, torch.int32, (num_r,)),
            ("replica_partition", s.replica_partition, torch.int32,
             (num_r,)),
            ("replica_base_load", s.replica_base_load, torch.float32,
             (num_r, 4)),
            ("partition_leader_bonus", s.partition_leader_bonus,
             torch.float32, (s.num_partitions, 4)),
            ("broker_capacity", s.broker_capacity, torch.float32,
             (num_b, 4)),
            ("broker_table", cache.broker_table, torch.int32, (num_b, sw)),
            ("out[broker_load]", out["broker_load"], torch.float32,
             (num_b, 4)),
            ("out[broker_util]", out["broker_util"], torch.float32,
             (num_b, 4)),
            ("out[replica_load]", out["replica_load"], torch.float32,
             (num_r, 4)),
            ("out[leader_count]", out["leader_count"], torch.int32,
             (num_b,)),
            ("out[leader_bytes_in]", out["leader_bytes_in"], torch.float32,
             (num_b,))):
        _check(t, name, dt, shape)
    if sw:
        _check(out["table_load"], "out[table_load]", torch.float32,
               (num_b, sw, 4))
        _check(out["table_leader"], "out[table_leader]", torch.bool,
               (num_b, sw))
        t_load, t_leader = out["table_load"], out["table_leader"]
    else:
        t_load, t_leader = cache.table_load, cache.table_leader
    contrib = torch.empty((n, 8), dtype=torch.float32, device=sr.device)
    ends = torch.empty((2, n), dtype=torch.int32, device=sr.device)
    err = lib.cc_commit_leadership(
        n, num_b, sw, num_r, sr.data_ptr(), dr.data_ptr(), valid.data_ptr(),
        s.replica_broker.data_ptr(), s.replica_partition.data_ptr(),
        s.replica_base_load.data_ptr(), s.partition_leader_bonus.data_ptr(),
        s.broker_capacity.data_ptr(), cache.broker_table.data_ptr(),
        out["broker_load"].data_ptr(), out["broker_util"].data_ptr(),
        out["replica_load"].data_ptr(), out["leader_count"].data_ptr(),
        out["leader_bytes_in"].data_ptr(), t_load.data_ptr(),
        t_leader.data_ptr(), contrib.data_ptr(), ends.data_ptr(),
        _stream())
    LAUNCHES["commit_leadership"] += 1
    _raise_on(err, "commit_leadership")


def sweep_pick(sel, has_in, cur_safe, rows, jit_plane, replica_broker,
               value_r, static_ok, alive, leader_ok, W, fill_to, hard_cap,
               tb_norm, salt: float, improve_gate: bool):
    """K6 launch: (dst_r i32[W], has bool[W])."""
    lib = build()
    wn = sel.shape[0]
    num_p, rf = rows.shape
    num_r = replica_broker.shape[0]
    num_b = alive.shape[0]
    for name, t, dt, shape in (
            ("sel", sel, torch.int32, (wn,)),
            ("has_in", has_in, torch.bool, (wn,)),
            ("cur_safe", cur_safe, torch.int32, (wn,)),
            ("rows", rows, torch.int32, (num_p, rf)),
            ("jit_plane", jit_plane, torch.float32, (num_p, rf)),
            ("replica_broker", replica_broker, torch.int32, (num_r,)),
            ("value_r", value_r, torch.float32, (num_r,)),
            ("static_ok", static_ok, torch.bool, (num_r,)),
            ("alive", alive, torch.bool, (num_b,)),
            ("leader_ok", leader_ok, torch.bool, (num_b,)),
            ("W", W, torch.float32, (num_b,)),
            ("fill_to", fill_to, torch.float32, (num_b,)),
            ("hard_cap", hard_cap, torch.float32, (num_b,))):
        _check(t, name, dt, shape)
    if tb_norm is not None:
        _check(tb_norm, "tb_norm", torch.float32, (num_b,))
    scratch = torch.empty(1, dtype=torch.int32, device=rows.device)
    dst_r = torch.empty(wn, dtype=torch.int32, device=rows.device)
    has = torch.empty(wn, dtype=torch.bool, device=rows.device)
    err = lib.cc_sweep_pick(
        wn, rf, sel.data_ptr(), has_in.data_ptr(), cur_safe.data_ptr(),
        rows.data_ptr(), jit_plane.data_ptr(), replica_broker.data_ptr(),
        value_r.data_ptr(), static_ok.data_ptr(), alive.data_ptr(),
        leader_ok.data_ptr(), W.data_ptr(), fill_to.data_ptr(),
        hard_cap.data_ptr(), tb_norm.data_ptr() if tb_norm is not None
        else None, float(salt), int(bool(improve_gate)), scratch.data_ptr(),
        dst_r.data_ptr(), has.data_ptr(), _stream())
    LAUNCHES["sweep_pick"] += 1
    _raise_on(err, "sweep_pick")
    return dst_r, has


def forced_select(forced: torch.Tensor, w: torch.Tensor,
                  replica_partition: torch.Tensor,
                  replica_broker: torch.Tensor,
                  partition_replicas: torch.Tensor, top_b: torch.Tensor,
                  top_h: torch.Tensor, k: int):
    """K7 launch: (cand_r i32[k], cand_has bool[k], forced_ok bool[R]);
    with k == 0 only the guard runs and the first two are None."""
    lib = build()
    num_r = forced.shape[0]
    num_p, rf = partition_replicas.shape
    nb = top_b.shape[0]
    if not 0 <= k <= min(4096, num_r):
        raise ValueError(f"forced_select takes 0 <= k <= min(4096, R), "
                         f"got k={k}")
    if nb > 32:
        raise ValueError(f"forced_select takes at most 32 top brokers, "
                         f"got {nb}")
    for name, t, dt, shape in (
            ("forced", forced, torch.bool, (num_r,)),
            ("w", w, torch.float32, (num_r,)),
            ("replica_partition", replica_partition, torch.int32, (num_r,)),
            ("replica_broker", replica_broker, torch.int32, (num_r,)),
            ("partition_replicas", partition_replicas, torch.int32,
             (num_p, rf)),
            ("top_b", top_b, torch.int32, (nb,)),
            ("top_h", top_h, torch.float32, (nb,))):
        _check(t, name, dt, shape)
    dev = forced.device
    forced_ok = torch.empty(num_r, dtype=torch.bool, device=dev)
    if k:
        keys = torch.empty(num_r, dtype=torch.int64, device=dev)
        hist = torch.empty(8 * 256, dtype=torch.int32, device=dev)
        sel = torch.empty(3, dtype=torch.int64, device=dev)
        out_keys = torch.empty(k, dtype=torch.int64, device=dev)
        cand_r = torch.empty(k, dtype=torch.int32, device=dev)
        cand_has = torch.empty(k, dtype=torch.bool, device=dev)
        scratch = [keys.data_ptr(), hist.data_ptr(), sel.data_ptr(),
                   out_keys.data_ptr(), cand_r.data_ptr(),
                   cand_has.data_ptr()]
    else:
        cand_r = cand_has = None
        scratch = [None] * 6
    err = lib.cc_forced_select(
        num_r, rf, nb, int(k), forced.data_ptr(), w.data_ptr(),
        replica_partition.data_ptr(), replica_broker.data_ptr(),
        partition_replicas.data_ptr(), top_b.data_ptr(), top_h.data_ptr(),
        forced_ok.data_ptr(), *scratch, _stream())
    LAUNCHES["forced_select"] += 1
    _raise_on(err, "forced_select")
    return cand_r, cand_has, forced_ok


def rank_accept(order: torch.Tensor, dest: torch.Tensor, has: torch.Tensor,
                num_b: int, taken_cnt: torch.Tensor, cap: torch.Tensor,
                cum_d, d_w, hr_d) -> torch.Tensor:
    """K8 launch: bool[C] acceptance after the lexsort `order` (int64[C]).
    `cum_d` / `hr_d` are T tensors f32[B] (or one f32[T, B]), `d_w` T
    tensors f32[C] (or one f32[T, C]); lists are stacked here."""
    lib = build()
    c = order.shape[0]
    n_terms = len(d_w)
    if not (len(cum_d) == len(hr_d) == n_terms):
        raise ValueError("rank_accept takes as many cumulants and headrooms "
                         "as weights")
    if num_b < 1 or c >= 2 ** 31 - 1:
        raise ValueError(f"rank_accept takes B >= 1 and C < 2**31 - 1, got "
                         f"B={num_b}, C={c}")
    dev = order.device

    def rows(x, n):
        if isinstance(x, torch.Tensor):
            return x
        return (torch.stack(list(x)) if n_terms
                else torch.empty((0, n), device=dev))
    cum, dw, hr = rows(cum_d, num_b), rows(d_w, c), rows(hr_d, num_b)
    for name, t, dt, shape in (
            ("order", order, torch.int64, (c,)),
            ("dest", dest, torch.int32, (c,)),
            ("has", has, torch.bool, (c,)),
            ("taken_cnt", taken_cnt, torch.int32, (num_b,)),
            ("cap", cap, torch.int32, (num_b,)),
            ("cum", cum, torch.float32, (n_terms, num_b)),
            ("d_w", dw, torch.float32, (n_terms, c)),
            ("hr", hr, torch.float32, (n_terms, num_b))):
        _check(t, name, dt, shape)
    out = torch.empty(c, dtype=torch.bool, device=dev)
    if c > 4096:
        levels = lib.cc_rank_accept_level_floats(c)
        s_i = torch.empty(3 * c, dtype=torch.int32, device=dev)
        s_ok = torch.empty(c, dtype=torch.bool, device=dev)
        s_ws = torch.empty(max(n_terms * c, 1), device=dev)
        s_cs = torch.empty(max(n_terms * levels, 1), device=dev)
        scratch = [s_i.data_ptr(), s_ok.data_ptr(), s_ws.data_ptr(),
                   s_cs.data_ptr()]
    else:
        scratch = [None] * 4
    err = lib.cc_rank_accept(
        c, num_b, n_terms, order.data_ptr(), dest.data_ptr(), has.data_ptr(),
        taken_cnt.data_ptr(), cap.data_ptr(), cum.data_ptr(), dw.data_ptr(),
        hr.data_ptr(), *scratch, out.data_ptr(), _stream())
    LAUNCHES["rank_accept"] += 1
    _raise_on(err, "rank_accept")
    return out
