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
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import numpy as np
import torch

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
SOURCES = ("row_topk.cu", "assign_pass.cu", "commit_moves.cu",
           "leader_assign.cu", "commit_leadership.cu", "sweep_pick.cu",
           "forced_select.cu", "rank_accept.cu", "segment_argmax.cu",
           "swap_pair.cu", "dest_feasibility.cu", "segment_sum.cu",
           "ordered_sum.cu", "cumsum_blocks.cu")
#: headers the sources include (K3 and K5 share their bucketing, K6 and K7
#: their top-k selection)
HEADERS = ("commit_bucket.cuh", "topk_select.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES = {"row_topk": 0, "assign_pass": 0, "commit_moves": 0,
            "leader_assign_pass": 0, "commit_leadership": 0, "sweep_pick": 0,
            "forced_select": 0, "rank_accept": 0, "segment_argmax": 0,
            "swap_pair": 0, "dest_feasibility": 0, "segment_sum": 0,
            "ordered_sum": 0, "cumsum_blocks": 0,
            # K8's launches split by path: one block (C <= 4096) and the
            # multi-launch path above
            "rank_accept_one_block": 0, "rank_accept_multi_launch": 0,
            # K9's keep entry and K11's preference plane and guard, each
            # also counted under its kernel
            "segment_keep": 0, "dest_pref": 0, "dest_has": 0}
#: launches split finer: K1's by source (a [B, S] plane, or per-replica
#: scores read through the table) and k ("row_topk table k=1"), K4's by
#: commit mode and pass ("leader_assign_pass multi pass 0"), K6's by
#: window and fold ("sweep_pick compact fold"), K10's by entry
#: ("swap_pair shortlist", "swap_pair plane"); cleared with LAUNCHES
LAUNCH_SPLITS: dict = {}
#: K1's widest k and row (csrc/row_topk.cu: the row's keys in shared memory)
ROW_TOPK_MAX_K = 64
ROW_TOPK_MAX_S = 16384
#: K1's paths (csrc/row_topk.cu): the select with a block of 256 a row
#: (0), the register path for k <= 8 (1), the select with a warp a row
#: (2).  Below ROW_TOPK_WARP_MIN_B rows the register path takes k up to
#: ROW_TOPK_REGISTER_MAX_K and the block select the rest; from there the
#: register path takes k up to ROW_TOPK_WIDE_REGISTER_MAX_K and the warp
#: select the rest.  chip_smoke.py phase 2 times every path at 200 x 1,152
#: and 2,600 x 1,024 (on an H100: the register path ahead at k <= 8 and
#: k <= 4, the block select at k = 16 and 64 on 200 rows, the warp select
#: from k = 8 on 2,600).  ROW_TOPK_PATH, when set, forces a path.
ROW_TOPK_REGISTER_MAX_K = 8
ROW_TOPK_WIDE_REGISTER_MAX_K = 4
ROW_TOPK_WARP_MIN_B = 1024
ROW_TOPK_PATH = None
#: K4's widest replication factor and most blocks (pass 0's amplitude
#: partials: two floats a block)
LEADER_MAX_RF = 16
LEADER_MAX_BLOCKS = 2048
#: K8's one-block path takes up to this many candidates
RANK_ONE_BLOCK_MAX = 4096
#: K12's most segments (a tile's running counts live in shared memory)
SEGMENT_MAX = 57_344
#: K12 walks a warp per segment when the segments average at least this
#: many entries, and a thread per (segment, column) below it.  chip_smoke.py
#: phase 2 times both walks: the thread walk is ahead at 4 to 12 entries and
#: at disk_load's 57.7 over 10,400 segments, the warp walk at 23 over 2,600
#: and from 75; 64 puts every shape of the main path on its faster walk
SEGMENT_WARP_WALK_AVG = 64
#: K13 takes its spread path (a block per 1,024 rows) above this many
#: rows, and a block per column at or below it
ORDERED_SPREAD_ROWS = 4096
#: the spread path's columns a block and its most column tiles
ORDERED_TILE_COLS = 8
ORDERED_MAX_COLUMN_TILES = 4096
#: the spread path's counter sets on a device: one for each stream that
#: launches it
ORDERED_COUNTER_SLOTS = 72
#: K14's gate: the most candidates a row and terms (csrc/cumsum_blocks.cu
#: kGroup, kMaxTerms)
GATE_MAX_K = 16
GATE_MAX_TERMS = 16
#: K2's widest shortlist (its broker ids and open mask live in shared
#: memory)
ASSIGN_MAX_K = 46_000
#: K9 (csrc/segment_argmax.cu): one block takes up to this many elements
#: (and, the dense entry, segments), its keys in shared memory up to
#: ARGMAX_ONE_BLOCK_SHARED_KEYS segments; every other call folds into a
#: global key scratch (wider calls: one cooperative grid)
ARGMAX_ONE_BLOCK_N = 4096
ARGMAX_ONE_BLOCK_DENSE_S = 1024
ARGMAX_ONE_BLOCK_SHARED_KEYS = 4096
#: the grid path folds into shared-memory keys first, a block per
#: ARGMAX_SHARE_PER_KEY * S elements (2,048 at least), when S keys fit and
#: the segments average ARGMAX_SHARED_MIN_AVG elements or more; else
#: straight into the scratch (28,672 keys: 224 KB of the block's 227 KB
#: opt-in shared memory)
ARGMAX_SHARED_KEYS = 28_672
ARGMAX_SHARE_PER_KEY = 0.5
ARGMAX_SHARED_MIN_AVG = 32
#: K11's widest replication factor (csrc/dest_feasibility.cu kMaxRF)
DEST_MAX_RF = 16

_LOCK = threading.Lock()
_LIB = None
#: {"seconds": build wall time, "log": nvcc's output, "path": the .so}
BUILD_INFO: dict = {}

_P = ctypes.c_void_p
_I = ctypes.c_int


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    LAUNCH_SPLITS.clear()


class KernelBuildError(RuntimeError):
    """The kernel library failed to build (nvcc missing or failing, the
    link) or to load (ctypes).  Not a solve failure the degradation
    ladder may step around: it raises through it."""


class KernelLaunchError(RuntimeError):
    """A kernel failed to launch or run (the CUDA error its C entry
    returned).  Not ladder material either: it raises through."""


class KernelContractError(KernelLaunchError, ValueError, TypeError):
    """A wrapper was called outside its kernel's contract (device,
    dtype, shape, alignment, limits): raised before any launch, and
    raised through the ladder as a failed launch is."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise KernelBuildError("nvcc not found: the CUDA kernels of "
                           "cruise_control_tpu_torch need the CUDA toolkit")


def build() -> ctypes.CDLL:
    """Compile (once per source content) and load the kernel library;
    KernelBuildError when either fails."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        t0 = time.time()
        digest = hashlib.sha256()
        for name in SOURCES + HEADERS:
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
                raise KernelBuildError("nvcc failed for " + ", ".join(failed)
                                       + "\n" + "\n".join(log))
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            link = subprocess.run(
                [nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                 "-shared", "-o", str(tmp), *map(str, objs)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            log.append(f"== link\n{link.stdout}")
            if link.returncode != 0:
                raise KernelBuildError("nvcc link failed\n" + "\n".join(log))
            os.replace(tmp, so)
        try:
            lib = ctypes.CDLL(str(so))
        except OSError as exc:
            raise KernelBuildError(f"the kernel library {so} failed to "
                                   f"load: {exc}") from exc
        lib.cc_row_topk.argtypes = [_P, _P, _I, _I, _I] + [_P] * 5 + [
            _I, _P]
        lib.cc_table_topk.argtypes = [_P, ctypes.c_longlong, _P, _I, _P, _I,
                                      _I, _I] + [_P] * 5 + [_I, _P]
        lib.cc_assign_pass.argtypes = [_P, _I, _I] + [_P] * 4 + [
            _I] + [_P] * 7 + [_I, _P]
        lib.cc_commit_moves.argtypes = [_I] * 7 + [_P] * 29 + [
            ctypes.c_longlong, _P]
        lib.cc_commit_moves_scratch.argtypes = [_I, _I]
        lib.cc_commit_moves_scratch.restype = ctypes.c_longlong
        _LL = ctypes.c_longlong
        lib.cc_leader_assign_pass.argtypes = (
            [_I] * 8 + [_P, _I, _P, _P, _LL, _LL] + [_P] * 4
            + [_P, _LL, _P, _LL, _P, _LL] + [_P] * 19 + [_I, _P])
        lib.cc_commit_leadership.argtypes = [_I] * 4 + [_P] * 18 + [
            ctypes.c_longlong, _P]
        lib.cc_commit_leadership_scratch.argtypes = [_I, _I]
        lib.cc_commit_leadership_scratch.restype = ctypes.c_longlong
        lib.cc_sweep_window.argtypes = [_I] * 6 + [ctypes.c_float] * 2 + [
            _P] * 15 + [_P, _LL] * 5 + [_P] * 15
        for fn in (lib.cc_sweep_window_partials, lib.cc_sweep_window_width,
                   lib.cc_select_hist_words, lib.cc_forced_select_max_k,
                   lib.cc_swap_max_shortlist):
            fn.argtypes = []
        lib.cc_forced_select.argtypes = [_I] * 4 + [_P] * 13 + [_P]
        lib.cc_rank_accept.argtypes = [_I] * 3 + [_P] * 9 + [_I] + [
            _P] * 6
        lib.cc_rank_accept_level_floats.argtypes = [_I]
        lib.cc_rank_accept_level_floats.restype = ctypes.c_longlong
        lib.cc_segment_argmax.argtypes = [_P, _P, _I, _P, _I, _I, _P, _I
                                          ] + [_P] * 4
        lib.cc_segment_keep.argtypes = [_P, _P, _I, _P, _I, _I, _P, _I, _P,
                                        _P]
        lib.cc_swap_shortlist.argtypes = [_I, _I] + [_P] * 6 + [
            _P, _LL] * 3 + [_P] * 6
        lib.cc_swap_pair_reset.argtypes = [_P, _P]
        lib.cc_swap_pair.argtypes = [_I] * 4 + [_P] * 8 + [
            _P, _LL] * 5 + [_P, _LL, _LL] + [_P] * 9
        _L = ctypes.c_longlong
        lib.cc_dest_pref.argtypes = [_I] * 3 + [_P, _I, _P, _I] + [
            _P] * 6 + [_L, _P, _L, _P, _L, _L, _P, _L, _P, _P]
        lib.cc_dest_has.argtypes = [_I] * 3 + [_P, _I, _P, _L, _P, _P,
                                               _L] + [_P] * 5
        lib.cc_segment_sum.argtypes = [_P, _P] + [_I] * 4 + [
            _P, _P, ctypes.c_longlong, _I, _P, _P]
        lib.cc_segment_sum_scratch.argtypes = [_I, _I, _I]
        lib.cc_segment_sum_scratch.restype = ctypes.c_longlong
        lib.cc_ordered_sum.argtypes = [_P, _I, _I, _P, ctypes.c_longlong,
                                       _I, _I, _P, _P]
        lib.cc_prefix_gate.argtypes = [_P, _P, _P, ctypes.c_longlong, _P,
                                       _I, _I, _I, _P, _P, _P]
        for fn in (lib.cc_row_topk, lib.cc_table_topk, lib.cc_assign_pass, lib.cc_commit_moves,
                   lib.cc_leader_assign_pass, lib.cc_commit_leadership,
                   lib.cc_sweep_window, lib.cc_sweep_window_partials,
                   lib.cc_forced_select,
                   lib.cc_rank_accept,
                   lib.cc_segment_argmax, lib.cc_segment_keep,
                   lib.cc_swap_shortlist, lib.cc_swap_pair,
                   lib.cc_swap_pair_reset,
                   lib.cc_dest_pref,
                   lib.cc_dest_has,
                   lib.cc_segment_sum, lib.cc_ordered_sum,
                   lib.cc_prefix_gate):
            fn.restype = ctypes.c_int
        from cruise_control_tpu_torch.analyzer.leadership import (
            SWEEP_COMPACT)
        if lib.cc_sweep_window_width() != SWEEP_COMPACT:
            raise KernelBuildError(
                f"csrc/sweep_pick.cu's window ({lib.cc_sweep_window_width()}"
                f") is not SWEEP_COMPACT ({SWEEP_COMPACT})")
        BUILD_INFO.update(seconds=time.time() - t0, log="\n".join(log),
                          path=str(so))
        _LIB = lib
        return lib


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _check(t: torch.Tensor, name: str, dtype, shape=None) -> None:
    if not t.is_cuda:
        raise KernelContractError(f"{name} must be a CUDA tensor")
    if t.dtype != dtype:
        raise KernelContractError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise KernelContractError(
            f"{name} must have shape {tuple(shape)}, "
            f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise KernelContractError(f"{name} must be contiguous")


def _check_rows4(t: torch.Tensor, name: str) -> None:
    """A plane the kernel reads or writes four floats at a time."""
    if t.data_ptr() % 16:
        raise KernelContractError(f"{name} must be 16-byte aligned")


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise KernelLaunchError(f"CUDA kernel {name} failed: error {err} "
                           f"({torch.cuda.get_device_name()})")


def _row_topk_outputs(b: int, k: int, dev) -> list:
    """K1's outputs: cand i32[B*k], has bool[B*k], top f32[B, k], slot
    i32[B, k], any bool[B]."""
    return [torch.empty(b * k, dtype=torch.int32, device=dev),
            torch.empty(b * k, dtype=torch.bool, device=dev),
            torch.empty((b, k), dtype=torch.float32, device=dev),
            torch.empty((b, k), dtype=torch.int32, device=dev),
            torch.empty(b, dtype=torch.bool, device=dev)]


def _row_topk_shape(table: torch.Tensor, k: int) -> tuple:
    b, s = table.shape
    if not (1 <= k <= min(ROW_TOPK_MAX_K, s) and s <= ROW_TOPK_MAX_S):
        raise KernelContractError(
            f"row_topk takes 1 <= k <= min({ROW_TOPK_MAX_K}, "
            f"S) and S <= {ROW_TOPK_MAX_S}, got k={k}, S={s}")
    _check(table, "table", torch.int32, (b, s))
    return b, s


def _row_topk_path(b: int, k: int) -> int:
    """K1's path for B rows and k (see ROW_TOPK_REGISTER_MAX_K)."""
    if ROW_TOPK_PATH is not None:
        return ROW_TOPK_PATH
    wide = b >= ROW_TOPK_WARP_MIN_B
    if k <= (ROW_TOPK_WIDE_REGISTER_MAX_K if wide
             else ROW_TOPK_REGISTER_MAX_K):
        return 1
    return 2 if wide else 0


def _row_topk_launched(source: str, k: int, err: int) -> None:
    LAUNCHES["row_topk"] += 1
    key = f"row_topk {source} k={k}"
    LAUNCH_SPLITS[key] = LAUNCH_SPLITS.get(key, 0) + 1
    _raise_on(err, "row_topk")


def row_topk(sc_rows: torch.Tensor, table: torch.Tensor, k: int):
    """K1 launch, plane source: (cand i32[B*k], has bool[B*k], top f32[B,
    k], slot i32[B, k], any bool[B])."""
    lib = build()
    b, s = _row_topk_shape(table, k)
    _check(sc_rows, "sc_rows", torch.float32, (b, s))
    out = _row_topk_outputs(b, k, sc_rows.device)
    err = lib.cc_row_topk(sc_rows.data_ptr(), table.data_ptr(), b, s, k,
                          *(t.data_ptr() for t in out), _row_topk_path(b, k),
                          _stream())
    _row_topk_launched("plane", k, err)
    return tuple(out)


def table_topk(table: torch.Tensor, score: torch.Tensor, valid: torch.Tensor,
               k: int):
    """K1 launch, table source: the top k of each row of valid[id] ?
    score[id] : NEG over the table's replica ids (a pad id R is NEG),
    read through the table; the outputs of `row_topk`.  `score` is read
    with its stride."""
    lib = build()
    b, s = _row_topk_shape(table, k)
    num_r = score.shape[0]
    _check_vector(score, "score", num_r)
    _check(valid, "valid", torch.bool, (num_r,))
    out = _row_topk_outputs(b, k, table.device)
    err = lib.cc_table_topk(score.data_ptr(), score.stride(0),
                            valid.data_ptr(), num_r, table.data_ptr(), b, s,
                            k, *(t.data_ptr() for t in out),
                            _row_topk_path(b, k), _stream())
    _row_topk_launched("table", k, err)
    return tuple(out)


def assign_pass(pref: torch.Tensor, dest_ids: torch.Tensor,
                taken_cnt: torch.Tensor, cap, cand_has: torch.Tensor, k: int,
                amp: torch.Tensor, assigned: torch.Tensor, dest: torch.Tensor,
                keep=None, prev_best=None):
    """K2 launch: (best i32[C] broker ids, has bool[C]).  Folds `keep` /
    `prev_best` (the pass before, or None) into `dest` and `assigned` in
    place; pass 0 writes `amp`, later passes read it.  `cap` (i32[B]) None
    means one arrival a destination."""
    lib = build()
    c, kk = pref.shape
    if not (1 <= kk <= ASSIGN_MAX_K and c >= 1):
        raise KernelContractError(
            f"assign_pass takes C >= 1 and 1 <= K <= "
            f"{ASSIGN_MAX_K}, got C={c}, K={kk}")
    num_b = taken_cnt.shape[0]
    _check(pref, "pref", torch.float32)
    _check(dest_ids, "dest_ids", torch.int32, (kk,))
    _check(taken_cnt, "taken_cnt", torch.int32, (num_b,))
    if cap is not None:
        _check(cap, "cap", torch.int32, (num_b,))
    _check(cand_has, "cand_has", torch.bool, (c,))
    _check(amp, "amp", torch.float32, ())
    _check(assigned, "assigned", torch.bool, (c,))
    _check(dest, "dest", torch.int32, (c,))
    if (keep is None) != (prev_best is None):
        raise KernelContractError(
            "assign_pass folds keep and prev_best together")
    if keep is not None:
        _check(keep, "keep", torch.bool, (c,))
        _check(prev_best, "prev_best", torch.int32, (c,))
    best = torch.empty(c, dtype=torch.int32, device=pref.device)
    has = torch.empty(c, dtype=torch.bool, device=pref.device)
    stream = _stream()
    err = lib.cc_assign_pass(
        pref.data_ptr(), c, kk, dest_ids.data_ptr(), taken_cnt.data_ptr(),
        cap.data_ptr() if cap is not None else None, cand_has.data_ptr(),
        int(k), amp.data_ptr(), assigned.data_ptr(), dest.data_ptr(),
        keep.data_ptr() if keep is not None else None,
        prev_best.data_ptr() if prev_best is not None else None,
        best.data_ptr(), has.data_ptr(),
        _ordered_slot(pref.device.index, stream) if k == 0 else 0, stream)
    LAUNCHES["assign_pass"] += 1
    _raise_on(err, "assign_pass")
    return best, has


#: the cache fields K3 writes in both modes, and with a broker table
AGGREGATE_FIELDS = ("broker_load", "broker_util", "replica_count",
                    "leader_count", "partition_rack_count",
                    "broker_topic_count", "potential_nw_out",
                    "leader_bytes_in")
TABLE_FIELDS = ("broker_table", "table_fill", "table_load", "table_bonus",
                "table_leader", "table_ok")


def commit_fields(cache) -> tuple:
    """The cache fields K3 writes for `cache`: the aggregates, and the
    table planes when the cache carries a table."""
    if cache.broker_table.shape[1]:
        return AGGREGATE_FIELDS + TABLE_FIELDS
    return AGGREGATE_FIELDS


def _planes(cache, fields, donate: bool) -> dict:
    """The planes K5 updates in place: with `donate` the cache's own (the
    caller gives the cache up), else copies; `broker_util` is written,
    not read, so its copy is left unfilled."""
    if donate:
        return {f: getattr(cache, f) for f in fields}
    return {f: (torch.empty_like(cache.broker_util) if f == "broker_util"
                else getattr(cache, f).clone()) for f in fields}


@functools.lru_cache(maxsize=256)
def _commit_scratch_bytes(kernel: str, n: int, num_b: int) -> int:
    got = getattr(build(), f"cc_{kernel}_scratch")(n, num_b)
    if got < 0:
        raise KernelContractError(
            f"{kernel} cannot bucket {n} rows into {num_b} "
            "brokers: past the limits of csrc/commit_bucket.cuh "
            "(at most 17,066 brokers; 1,048,576 rows up to "
            "5,120 brokers, fewer above)")
    return got


def _commit_scratch(kernel: str, n: int, num_b: int, device):
    """One scratch allocation per commit: the bucket metadata and the
    keys' rows in bucket order."""
    return torch.empty(_commit_scratch_bytes(kernel, n, num_b),
                       dtype=torch.uint8, device=device)


def commit_moves(state_before, cache, r: torch.Tensor, dst: torch.Tensor,
                 valid: torch.Tensor, rank_out=None) -> dict:
    """K3: commit the batch into the cache's own planes, in place (the
    caller gives the cache up; a caller that keeps it commits into a
    copy), and return them.  A move counts when valid[i] and its replica
    is not on dst[i] already; the kernel ranks the arrivals at each
    destination itself.  Without a broker table (table-less mode) the
    aggregates only.  `rank_out` (i32[n], a test's probe) gets each
    counted arrival's rank at its destination and -1 for a move that does
    not count."""
    out = {f: getattr(cache, f) for f in commit_fields(cache)}
    lib = build()
    n = r.shape[0]
    s = state_before
    num_b = s.num_brokers
    num_r = s.num_replicas
    sw = cache.broker_table.shape[1]
    for name, t, dt, shape in (
            ("r", r, torch.int32, (n,)), ("dst", dst, torch.int32, (n,)),
            ("valid", valid, torch.bool, (n,)),
            ("replica_broker", s.replica_broker, torch.int32, (num_r,)),
            ("replica_partition", s.replica_partition, torch.int32,
             (num_r,)),
            ("replica_is_leader", s.replica_is_leader, torch.bool,
             (num_r,)),
            ("replica_base_load", s.replica_base_load, torch.float32,
             (num_r, 4)),
            ("partition_leader_bonus", s.partition_leader_bonus,
             torch.float32, (s.num_partitions, 4)),
            ("partition_topic", s.partition_topic, torch.int32,
             (s.num_partitions,)),
            ("broker_rack", s.broker_rack, torch.int32, (num_b,)),
            ("broker_capacity", s.broker_capacity, torch.float32,
             (num_b, 4)),
            ("replica_load", cache.replica_load, torch.float32, (num_r, 4)),
            ("replica_ok", cache.replica_ok, torch.bool, None)):
        _check(t, name, dt, shape)
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    planes = {"broker_load": (f32, (num_b, 4)),
              "broker_util": (f32, (num_b, 4)),
              "replica_count": (i32, (num_b,)),
              "leader_count": (i32, (num_b,)),
              "partition_rack_count": (i32, (s.num_partitions, s.num_racks)),
              "broker_topic_count": (i32, (num_b, s.num_topics)),
              "potential_nw_out": (f32, (num_b,)),
              "leader_bytes_in": (f32, (num_b,)),
              "broker_table": (i32, (num_b, sw)),
              "table_fill": (i32, (num_b,)),
              "table_load": (f32, (num_b, sw, 4)),
              "table_bonus": (f32, (num_b, sw, 4)),
              "table_leader": (b8, (num_b, sw)),
              "table_ok": (b8, (num_b, sw))}
    for f, t in out.items():
        _check(t, f, *planes[f])
    for name, t in (("replica_load", cache.replica_load),
                    ("partition_leader_bonus", s.partition_leader_bonus),
                    *((f, out[f]) for f in ("table_load", "table_bonus")
                      if sw)):
        _check_rows4(t, name)
    if rank_out is not None:
        _check(rank_out, "rank_out", torch.int32, (n,))

    def ptr(f):
        return out[f].data_ptr() if sw else None
    scratch = _commit_scratch("commit_moves", n, num_b, r.device)
    err = lib.cc_commit_moves(
        n, num_b, sw, num_r, s.num_racks, s.num_topics,
        cache.replica_ok.shape[0],
        r.data_ptr(), dst.data_ptr(), valid.data_ptr(),
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
        out["leader_bytes_in"].data_ptr(), ptr("broker_table"),
        ptr("table_fill"), ptr("table_load"), ptr("table_bonus"),
        ptr("table_leader"), ptr("table_ok"),
        None if rank_out is None else rank_out.data_ptr(),
        scratch.data_ptr(), scratch.numel(), _stream())
    LAUNCHES["commit_moves"] += 1
    _raise_on(err, "commit_moves")
    return out


def leader_assign_pass(t, k: int, multi: bool, keep=None, prev_db=None,
                       prev_dr=None):
    """K4 launch: pass k of a follower assignment over the buffers `t`
    (analyzer/kernels.py LeaderTail), in place; pass k > 0 folds `keep`,
    `prev_db` and `prev_dr` (the pass before).  (db i32[C], dr i32[C], has
    bool[C])."""
    from cruise_control_tpu_torch.analyzer.kernels import \
        MAX_ARRIVALS_PER_ROUND
    lib = build()
    c, rf = t.sib.shape
    num_r = t.replica_broker.shape[0]
    num_b = t.leader_ok.shape[0]
    if not 1 <= rf <= LEADER_MAX_RF:
        raise KernelContractError(
            f"leader_assign_pass takes 1 <= RF <= "
            f"{LEADER_MAX_RF}, got {rf}")
    if t.rows.dtype not in (torch.int32, torch.int64):
        raise KernelContractError(
            f"rows must be int32 or int64, got {t.rows.dtype}")
    for name, x, dt, shape in (
            ("rows", t.rows, t.rows.dtype, (c,)),
            ("sib", t.sib, torch.int32, (c, rf)),
            ("cand_has", t.cand_has, torch.bool, (c,)),
            ("replica_broker", t.replica_broker, torch.int32, (num_r,)),
            ("replica_offline", t.replica_offline, torch.bool, (num_r,)),
            ("leader_ok", t.leader_ok, torch.bool, (num_b,)),
            ("pref", t.pref, torch.float32, (c, rf)),
            ("sib_broker", t.sib_broker, torch.int32, (c, rf)),
            ("sib_replica", t.sib_replica, torch.int32, (c, rf)),
            ("src", t.src, torch.int32, (c,)),
            ("gain", t.gain, torch.float32, (c,)),
            ("amp", t.amp, torch.float32, ()),
            ("taken_cnt", t.taken_cnt, torch.int32, (num_b,)),
            ("dep_cnt", t.dep_cnt, torch.int32, (num_b,)),
            ("assigned", t.assigned, torch.bool, (c,)),
            ("dest_replica", t.dest_replica, torch.int32, (c,))):
        _check(x, name, dt, shape)
    _check_vector(t.bonus_w, "bonus_w", num_r)
    _check_vector(t.dest_headroom, "dest_headroom", num_b)
    _check_vector(t.dest_pref, "dest_pref", num_b)
    if not t.accept.is_cuda or t.accept.dtype != torch.bool:
        raise KernelContractError("accept must be a bool CUDA tensor")
    accept = t.accept.expand(c, rf)
    n_terms = 0
    if multi:
        n_terms = t.t_ws.shape[0]
        _check(t.t_ws, "t_ws", torch.float32, (n_terms, num_r))
        _check(t.d_w, "d_w", torch.float32, (n_terms, c))
    if k:
        for name, x, dt in (("keep", keep, torch.bool),
                            ("prev_db", prev_db, torch.int32),
                            ("prev_dr", prev_dr, torch.int32)):
            if x is None:
                raise KernelContractError(
                    f"leader_assign_pass pass {k} folds {name}")
            _check(x, name, dt, (c,))
    dev = t.sib.device
    db = torch.empty(c, dtype=torch.int32, device=dev)
    dr = torch.empty(c, dtype=torch.int32, device=dev)
    has = torch.empty(c, dtype=torch.bool, device=dev)
    partials = (torch.empty(2 * LEADER_MAX_BLOCKS, dtype=torch.float32,
                            device=dev) if k == 0 else None)
    err = lib.cc_leader_assign_pass(
        c, rf, num_r, num_b, n_terms, int(k), int(bool(multi)),
        MAX_ARRIVALS_PER_ROUND, t.rows.data_ptr(),
        int(t.rows.dtype == torch.int64), t.sib.data_ptr(),
        accept.data_ptr(), accept.stride(0), accept.stride(1),
        t.cand_has.data_ptr(), t.replica_broker.data_ptr(),
        t.leader_ok.data_ptr(), t.replica_offline.data_ptr(),
        t.bonus_w.data_ptr(), t.bonus_w.stride(0),
        t.dest_headroom.data_ptr(), t.dest_headroom.stride(0),
        t.dest_pref.data_ptr(), t.dest_pref.stride(0), t.pref.data_ptr(),
        t.sib_broker.data_ptr(), t.sib_replica.data_ptr(), t.src.data_ptr(),
        t.gain.data_ptr(), t.amp.data_ptr(), t.taken_cnt.data_ptr(),
        t.dep_cnt.data_ptr(), t.assigned.data_ptr(),
        t.dest_replica.data_ptr(), _ptr(keep), _ptr(prev_db),
        _ptr(prev_dr), _ptr(t.t_ws) if multi else None,
        _ptr(t.d_w) if multi else None, db.data_ptr(), dr.data_ptr(),
        has.data_ptr(), _ptr(partials),
        0 if partials is None else partials.numel(), _stream())
    LAUNCHES["leader_assign_pass"] += 1
    key = (f"leader_assign_pass {'multi' if multi else 'single'} "
           f"pass {'0' if k == 0 else '1+'}")
    LAUNCH_SPLITS[key] = LAUNCH_SPLITS.get(key, 0) + 1
    _raise_on(err, "leader_assign_pass")
    return db, dr, has


def commit_leadership(state_before, cache, sr: torch.Tensor,
                      dr: torch.Tensor, valid: torch.Tensor,
                      donate: bool = False) -> dict:
    """K5: the cache fields after a leadership-transfer batch.  With
    `donate` the kernel updates the cache's own planes in place (the
    caller gives the cache up); otherwise it writes into copies."""
    from cruise_control_tpu_torch.analyzer.context import LEADERSHIP_FIELDS
    sw = cache.broker_table.shape[1]
    out = _planes(cache, [f for f in LEADERSHIP_FIELDS
                          if sw or not f.startswith("table_")], donate)
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
    for name, t in (("partition_leader_bonus", s.partition_leader_bonus),
                    ("out[replica_load]", out["replica_load"])):
        _check_rows4(t, name)
    if sw:
        _check(out["table_load"], "out[table_load]", torch.float32,
               (num_b, sw, 4))
        _check_rows4(out["table_load"], "out[table_load]")
        _check(out["table_leader"], "out[table_leader]", torch.bool,
               (num_b, sw))
        _check(cache.table_fill, "table_fill", torch.int32, (num_b,))
        t_load = out["table_load"].data_ptr()
        t_leader = out["table_leader"].data_ptr()
        fill = cache.table_fill.data_ptr()
    else:
        t_load = t_leader = fill = None
    scratch = _commit_scratch("commit_leadership", n, num_b, sr.device)
    err = lib.cc_commit_leadership(
        n, num_b, sw, num_r, sr.data_ptr(), dr.data_ptr(), valid.data_ptr(),
        s.replica_broker.data_ptr(), s.replica_partition.data_ptr(),
        s.replica_base_load.data_ptr(), s.partition_leader_bonus.data_ptr(),
        s.broker_capacity.data_ptr(), cache.broker_table.data_ptr(), fill,
        out["broker_load"].data_ptr(), out["broker_util"].data_ptr(),
        out["replica_load"].data_ptr(), out["leader_count"].data_ptr(),
        out["leader_bytes_in"].data_ptr(), t_load, t_leader,
        scratch.data_ptr(), scratch.numel(), _stream())
    LAUNCHES["commit_leadership"] += 1
    _raise_on(err, "commit_leadership")


_SWEEP_SCRATCH: dict = {}


def _sweep_scratch(num_p: int, wn: int, dev: torch.device) -> list:
    """K6's scratch: per-block partials and, when the window of wn
    compacts, the [P] gains, listed flags and keys, the digit counts and
    the selected keys.  Reused on a stream (launches on one stream run in
    order); a CUDA graph capture gets its own."""
    key = (dev.index, _stream(), num_p)
    bufs = _SWEEP_SCRATCH.get(key)
    if bufs is not None:
        return bufs
    lib = build()
    bufs = [torch.empty(lib.cc_sweep_window_partials(), dtype=torch.float32,
                        device=dev)]
    if num_p > wn:
        bufs += [torch.empty(num_p, dtype=torch.float32, device=dev),
                 torch.empty(num_p, dtype=torch.uint8, device=dev),
                 torch.empty(num_p, dtype=torch.int64, device=dev),
                 torch.empty(lib.cc_select_hist_words(), dtype=torch.int32,
                             device=dev),
                 torch.empty(wn, dtype=torch.int64, device=dev)]
    else:
        bufs += [None] * 5
    if not torch.cuda.is_current_stream_capturing():
        _SWEEP_SCRATCH[key] = bufs
    return bufs


def sweep_window(cur, failed, prev, rows, jit_plane, replica_broker,
                 replica_partition, value_r, static_ok, alive, leader_ok, W,
                 shed_to, fill_to, hard_cap, tb, salt: float,
                 improve_gate: bool, select_jitter: float):
    """K6 launch: one sweep round's window, folding `prev` (the previous
    round's window tuple and its acceptance, or None) into `cur` and
    `failed` in place.  (sel i64[Wn], has bool, live_w bool, cur_safe i64,
    src_b i32, value_leave f32, dst_r i64, dst_b i32), Wn = min(P,
    SWEEP_COMPACT).  One cooperative launch."""
    from cruise_control_tpu_torch.analyzer.leadership import SWEEP_COMPACT
    lib = build()
    num_p, rf = rows.shape
    num_r = replica_broker.shape[0]
    num_b = alive.shape[0]
    wn = min(num_p, SWEEP_COMPACT)
    for name, t, dt, shape in (
            ("cur", cur, torch.int32, (num_p,)),
            ("failed", failed, torch.float32, (num_p,)),
            ("rows", rows, torch.int32, (num_p, rf)),
            ("jit_plane", jit_plane, torch.float32, (num_p, rf)),
            ("replica_broker", replica_broker, torch.int32, (num_r,)),
            ("replica_partition", replica_partition, torch.int32, (num_r,)),
            ("value_r", value_r, torch.float32, (num_r,)),
            ("static_ok", static_ok, torch.bool, (num_r,)),
            ("alive", alive, torch.bool, (num_b,)),
            ("leader_ok", leader_ok, torch.bool, (num_b,))):
        _check(t, name, dt, shape)
    vecs = (W, shed_to, fill_to, hard_cap, tb)
    for name, t in zip(("W", "shed_to", "fill_to", "hard_cap", "tb"), vecs):
        if t is not None:
            _check_vector(t, name, num_b, broadcast=True)
    if prev is None:
        p_ptrs = [None] * 5
    else:
        win, valid = prev
        for name, t, dt in (("prev sel", win[0], torch.int64),
                            ("prev live_w", win[2], torch.bool),
                            ("prev cur_safe", win[3], torch.int64),
                            ("prev dst_r", win[6], torch.int64),
                            ("prev valid", valid, torch.bool)):
            _check(t, name, dt, (wn,))
        p_ptrs = [win[0].data_ptr(), win[3].data_ptr(), win[6].data_ptr(),
                  valid.data_ptr(), win[2].data_ptr()]
    dev = rows.device
    scratch = _sweep_scratch(num_p, wn, dev)
    out = [torch.empty(wn, dtype=dt, device=dev) for dt in (
        torch.int64, torch.bool, torch.bool, torch.int64, torch.int32,
        torch.float32, torch.int64, torch.int32)]
    salt32 = np.float32(salt)
    salt_i = int(salt32 * np.float32(100.0))
    err = lib.cc_sweep_window(
        num_p, rf, num_b, int(prev is not None), int(bool(improve_gate)),
        salt_i, float(salt32), float(np.float32(select_jitter)),
        cur.data_ptr(), failed.data_ptr(), *p_ptrs, rows.data_ptr(),
        jit_plane.data_ptr(), replica_broker.data_ptr(),
        replica_partition.data_ptr(), value_r.data_ptr(),
        static_ok.data_ptr(), alive.data_ptr(), leader_ok.data_ptr(),
        *[x for t in vecs for x in (_ptr(t), _stride(t))],
        *[_ptr(t) for t in scratch], *[t.data_ptr() for t in out],
        _stream())
    LAUNCHES["sweep_pick"] += 1
    key = (f"sweep_pick {'compact' if num_p > wn else 'whole'} "
           f"{'fold' if prev is not None else 'first'}")
    LAUNCH_SPLITS[key] = LAUNCH_SPLITS.get(key, 0) + 1
    _raise_on(err, "sweep_pick")
    return tuple(out)


def forced_select(forced: torch.Tensor, w: torch.Tensor,
                  replica_partition: torch.Tensor,
                  replica_broker: torch.Tensor,
                  partition_replicas: torch.Tensor, top_b: torch.Tensor,
                  top_h: torch.Tensor, k: int):
    """K7 launch: (cand_r i32[k], cand_has bool[k], forced_ok bool[R]);
    with k == 0 only the guard runs and the first two are None.  For k >
    0 one cooperative launch."""
    lib = build()
    num_r = forced.shape[0]
    num_p, rf = partition_replicas.shape
    nb = top_b.shape[0]
    max_k = lib.cc_forced_select_max_k()
    if not 0 <= k <= min(max_k, num_r):
        raise KernelContractError(
            f"forced_select takes 0 <= k <= min({max_k}, R), "
            f"got k={k}")
    if nb > 32:
        raise KernelContractError(
            f"forced_select takes at most 32 top brokers, "
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
        # the guarded keys, the digit counts with two counters (zeroed by
        # the kernel), the selected keys
        listed = torch.empty(num_r, dtype=torch.int64, device=dev)
        hist = torch.empty(lib.cc_select_hist_words(), dtype=torch.int32,
                           device=dev)
        sel_keys = torch.empty(k, dtype=torch.int64, device=dev)
        cand_r = torch.empty(k, dtype=torch.int32, device=dev)
        cand_has = torch.empty(k, dtype=torch.bool, device=dev)
        scratch = [listed.data_ptr(), hist.data_ptr(), sel_keys.data_ptr(),
                   cand_r.data_ptr(), cand_has.data_ptr()]
    else:
        cand_r = cand_has = None
        scratch = [None] * 5
    err = lib.cc_forced_select(
        num_r, rf, nb, int(k), forced.data_ptr(),
        w.data_ptr(), replica_partition.data_ptr(),
        replica_broker.data_ptr(), partition_replicas.data_ptr(),
        top_b.data_ptr(), top_h.data_ptr(), forced_ok.data_ptr(), *scratch,
        _stream())
    LAUNCHES["forced_select"] += 1
    _raise_on(err, "forced_select")
    return cand_r, cand_has, forced_ok


def rank_accept(dest: torch.Tensor, gain: torch.Tensor, has: torch.Tensor,
                num_b: int, taken_cnt: torch.Tensor, cap: torch.Tensor,
                cum_d, d_w, hr_d, order=None,
                commit: bool = False) -> torch.Tensor:
    """K8 launch: bool[C] acceptance.  Up to C = 4096 one block sorts
    (unless the lexsort `order`, int64[C], is given), accepts and, with
    `commit`, commits; above, `order` is required, the steps are separate
    launches and the commit one more.  With `commit`, `taken_cnt` (i32[B])
    and `cum_d` (one f32[T, B] tensor) are updated in place.  `cum_d` /
    `hr_d` are T tensors f32[B] (or one f32[T, B]), `d_w` T tensors f32[C]
    (or one f32[T, C]); lists are stacked here."""
    lib = build()
    c = dest.shape[0]
    n_terms = len(d_w)
    if not (len(cum_d) == len(hr_d) == n_terms):
        raise KernelContractError(
            "rank_accept takes as many cumulants and headrooms "
            "as weights")
    if not 1 <= num_b <= 65534 or c * (n_terms + 1) >= 2 ** 31 - 1:
        raise KernelContractError(
            f"rank_accept takes 1 <= B <= 65534 and C * (T + "
            f"1) < 2**31 - 1, got B={num_b}, C={c}, "
            f"T={n_terms}")
    if c > RANK_ONE_BLOCK_MAX and order is None:
        raise KernelContractError(
            f"rank_accept above C = {RANK_ONE_BLOCK_MAX} takes "
            "the lexsort order")
    if commit and not isinstance(cum_d, torch.Tensor):
        raise KernelContractError(
            "rank_accept's commit updates one f32[T, B] "
            "cumulant tensor in place")
    dev = dest.device

    def rows(x, n):
        if isinstance(x, torch.Tensor):
            return x
        return (torch.stack(list(x)) if n_terms
                else torch.empty((0, n), device=dev))
    cum, dw, hr = rows(cum_d, num_b), rows(d_w, c), rows(hr_d, num_b)
    for name, t, dt, shape in (
            ("dest", dest, torch.int32, (c,)),
            ("gain", gain, torch.float32, (c,)),
            ("has", has, torch.bool, (c,)),
            ("taken_cnt", taken_cnt, torch.int32, (num_b,)),
            ("cap", cap, torch.int32, (num_b,)),
            ("cum", cum, torch.float32, (n_terms, num_b)),
            ("d_w", dw, torch.float32, (n_terms, c)),
            ("hr", hr, torch.float32, (n_terms, num_b))):
        _check(t, name, dt, shape)
    if order is not None:
        _check(order, "order", torch.int64, (c,))
    out = torch.empty(c, dtype=torch.bool, device=dev)
    one_block = c <= RANK_ONE_BLOCK_MAX
    if not one_block:
        levels = lib.cc_rank_accept_level_floats(c)
        s_i = torch.empty(4 * c, dtype=torch.int32, device=dev)
        s_ok = torch.empty(c, dtype=torch.bool, device=dev)
        s_ws = torch.empty(max(n_terms * c, 1), device=dev)
        s_cs = torch.empty(max(n_terms * levels, 1), device=dev)
        scratch = [s_i.data_ptr(), s_ok.data_ptr(), s_ws.data_ptr(),
                   s_cs.data_ptr()]
    else:
        scratch = [None] * 4
    err = lib.cc_rank_accept(
        c, num_b, n_terms, order.data_ptr() if order is not None else None,
        dest.data_ptr(), gain.data_ptr(), has.data_ptr(),
        taken_cnt.data_ptr(), cap.data_ptr(), cum.data_ptr(), dw.data_ptr(),
        hr.data_ptr(), int(bool(commit)), *scratch, out.data_ptr(),
        _stream())
    LAUNCHES["rank_accept"] += 1
    LAUNCHES["rank_accept_one_block" if one_block
             else "rank_accept_multi_launch"] += 1
    _raise_on(err, "rank_accept")
    return out


_ARGMAX_SCRATCH: dict = {}


def argmax_scratch(device: int, stream: int, num_segments: int = 1):
    """K9's global key scratch of a stream of a device: at least
    `num_segments` keys (int64), zero between launches (each launch clears
    what it set); grown, zeroed, when a call needs more.  It is never
    allocated or grown while the stream captures a CUDA graph (a graph
    would keep the address of a buffer that a later growth frees): run one
    call of the widest S on the stream before the capture."""
    key = (device, stream)
    buf = _ARGMAX_SCRATCH.get(key)
    if buf is None or buf.numel() < num_segments:
        if torch.cuda.is_current_stream_capturing():
            raise KernelContractError(
                f"segment_argmax needs {num_segments} scratch keys on a "
                f"stream that is capturing a CUDA graph and holds "
                f"{0 if buf is None else buf.numel()}: call it once on this "
                "stream before the capture")
        with _LOCK:
            buf = _ARGMAX_SCRATCH.get(key)
            if buf is None or buf.numel() < num_segments:
                size = max(num_segments, 1,
                           0 if buf is None else 2 * buf.numel())
                buf = torch.zeros(size, dtype=torch.int64,
                                  device=torch.device("cuda", device))
                _ARGMAX_SCRATCH[key] = buf
    return buf


def argmax_share(n: int, num_segments: int) -> int:
    """Elements a block of K9's grid path folds into shared-memory keys,
    or 0 to fold straight into the global scratch: shared keys when S
    keys fit (ARGMAX_SHARED_KEYS) and the segments average at least
    ARGMAX_SHARED_MIN_AVG elements, a block per ARGMAX_SHARE_PER_KEY * S
    of them."""
    share = int(ARGMAX_SHARE_PER_KEY * num_segments)
    if (share <= 0 or num_segments > ARGMAX_SHARED_KEYS
            or n < ARGMAX_SHARED_MIN_AVG * num_segments):
        return 0
    return share


def _argmax_inputs(score, segment, valid, num_segments: int, keep: bool):
    """Check K9's inputs: (n, seg64, the scratch's address (None when the
    launch keeps its keys in shared memory), share, stream)."""
    n = score.shape[0]
    if num_segments < 0 or n >= 2 ** 31 - 1:
        raise KernelContractError(
            f"segment_argmax takes S >= 0 and n < 2**31 - 1, "
            f"got S={num_segments}, n={n}")
    if segment.dtype not in (torch.int32, torch.int64):
        raise KernelContractError(
            f"segment must be int32 or int64, got "
            f"{segment.dtype}")
    for name, t, dt in (("score", score, torch.float32),
                        ("segment", segment, segment.dtype),
                        ("valid", valid, torch.bool)):
        _check(t, name, dt, (n,))
    stream = _stream()
    one_block = n <= ARGMAX_ONE_BLOCK_N and (
        keep or num_segments <= ARGMAX_ONE_BLOCK_DENSE_S)
    if one_block and num_segments <= ARGMAX_ONE_BLOCK_SHARED_KEYS:
        return n, int(segment.dtype == torch.int64), None, 0, stream
    share = 0 if one_block else argmax_share(n, num_segments)
    scratch = argmax_scratch(score.device.index, stream, num_segments)
    return (n, int(segment.dtype == torch.int64), scratch.data_ptr(), share,
            stream)


def segment_argmax(score: torch.Tensor, segment: torch.Tensor,
                   valid: torch.Tensor, num_segments: int):
    """K9 launch, dense entry: (arg i32[S], max f32[S], has bool[S]) per
    segment, the lowest index of the max-score valid element (segment ids
    int32 or int64, ids outside [0, S) dropped).  One allocation holds
    the three outputs."""
    lib = build()
    n, seg64, scratch, share, stream = _argmax_inputs(
        score, segment, valid, num_segments, keep=False)
    s = num_segments
    out = torch.empty(9 * s, dtype=torch.uint8, device=score.device)
    arg = out[:4 * s].view(torch.int32)
    mx = out[4 * s:8 * s].view(torch.float32)
    has = out[8 * s:].view(torch.bool)
    err = lib.cc_segment_argmax(score.data_ptr(), segment.data_ptr(), seg64,
                                valid.data_ptr(), n, s, scratch, share,
                                arg.data_ptr(), mx.data_ptr(),
                                has.data_ptr(), stream)
    LAUNCHES["segment_argmax"] += 1
    _raise_on(err, "segment_argmax")
    return arg, mx, has


def segment_keep(score: torch.Tensor, segment: torch.Tensor,
                 valid: torch.Tensor, num_segments: int) -> torch.Tensor:
    """K9 launch, keep entry: bool[n], valid[i] and i the lowest-index
    max-score valid element of its segment (analyzer/kernels.py
    resolve_dest_conflicts_plain with dest = segment); nothing S long is
    written or read."""
    lib = build()
    n, seg64, scratch, share, stream = _argmax_inputs(
        score, segment, valid, num_segments, keep=True)
    keep = torch.empty(n, dtype=torch.bool, device=score.device)
    err = lib.cc_segment_keep(score.data_ptr(), segment.data_ptr(), seg64,
                              valid.data_ptr(), n, num_segments, scratch,
                              share, keep.data_ptr(), stream)
    LAUNCHES["segment_argmax"] += 1
    LAUNCHES["segment_keep"] += 1
    _raise_on(err, "segment_keep")
    return keep


def _swap_launched(entry: str, err: int) -> None:
    LAUNCHES["swap_pair"] += 1
    key = f"swap_pair {entry}"
    LAUNCH_SPLITS[key] = LAUNCH_SPLITS.get(key, 0) + 1
    _raise_on(err, f"swap_pair ({entry})")


def swap_shortlist(hot, cold, out_r, in_r, out_has, in_has, dev_u, util,
                   target, h: int):
    """K10a launch: (h_ids i64[H], c_ids i64[H], out_h i64[H], in_c
    i64[H], dev_u f32[B]): each side's top H brokers by its rank, the
    picks at them, and the deviations (the given dev_u, or util - target
    computed by the kernel)."""
    lib = build()
    num_b = hot.shape[0]
    max_h = lib.cc_swap_max_shortlist()
    if not 1 <= h <= min(num_b, max_h):
        raise KernelContractError(
            f"swap_shortlist takes 1 <= H <= min(B, {max_h}), "
            f"got {h}")
    for name, t, dt in (("hot", hot, torch.bool), ("cold", cold, torch.bool),
                        ("out_r", out_r, torch.int32),
                        ("in_r", in_r, torch.int32),
                        ("out_has", out_has, torch.bool),
                        ("in_has", in_has, torch.bool)):
        _check(t, name, dt, (num_b,))
    dev = hot.device
    if dev_u is not None:
        _check_vector(dev_u, "dev_u", num_b, broadcast=True)
        util = target = dev_out = None
        dev_res = dev_u
    else:
        _check_vector(util, "util", num_b, broadcast=True)
        _check_vector(target, "target", num_b, broadcast=True)
        dev_out = dev_res = torch.empty(num_b, dtype=torch.float32,
                                        device=dev)
    out = [torch.empty(h, dtype=torch.int64, device=dev) for _ in range(4)]
    err = lib.cc_swap_shortlist(
        num_b, h, hot.data_ptr(), cold.data_ptr(), out_has.data_ptr(),
        in_has.data_ptr(), out_r.data_ptr(), in_r.data_ptr(), _ptr(dev_u),
        _stride(dev_u), _ptr(util), _stride(util), _ptr(target),
        _stride(target), _ptr(dev_out), *[t.data_ptr() for t in out],
        _stream())
    _swap_launched("shortlist", err)
    return (*out, dev_res)


_SWAP_DONE: dict = {}


def _swap_done(dev: torch.device) -> torch.Tensor:
    """K10b's last-block counter of a stream of a device, zero between
    launches (the last block resets it; zeroed once by a memset, not a
    torch op).  It is never allocated while the stream captures a CUDA
    graph: run one call on the stream first."""
    key = (dev.index, _stream())
    buf = _SWAP_DONE.get(key)
    if buf is None:
        if torch.cuda.is_current_stream_capturing():
            raise KernelContractError(
                "swap_pair's counter is allocated on a "
                "stream that captures a CUDA graph: call it "
                "once on this stream before the capture")
        buf = torch.empty(1, dtype=torch.int32, device=dev)
        _raise_on(build().cc_swap_pair_reset(buf.data_ptr(), _stream()),
                  "swap_pair (its counter's reset)")
        _SWAP_DONE[key] = buf
    return buf


def swap_pair(h_ids, c_ids, out_r, in_r, out_has, in_has, hot, cold, w,
              dev_u, util, lower, upper, accept, replica_partition,
              partition_replicas, replica_broker):
    """K10b launch: (cold i32[B], valid bool[B]): each shortlisted hot
    broker's cold partner and whether the swap survives the three
    conflict resolutions, zeros off the shortlist."""
    lib = build()
    nh, nc = h_ids.shape[0], c_ids.shape[0]
    num_b = hot.shape[0]
    num_r = replica_broker.shape[0]
    num_p, rf = partition_replicas.shape
    for name, t, dt, shape in (
            ("h_ids", h_ids, torch.int64, (nh,)),
            ("c_ids", c_ids, torch.int64, (nc,)),
            ("out_r", out_r, torch.int32, (num_b,)),
            ("in_r", in_r, torch.int32, (num_b,)),
            ("out_has", out_has, torch.bool, (num_b,)),
            ("in_has", in_has, torch.bool, (num_b,)),
            ("hot", hot, torch.bool, (num_b,)),
            ("cold", cold, torch.bool, (num_b,)),
            ("replica_partition", replica_partition, torch.int32, (num_r,)),
            ("partition_replicas", partition_replicas, torch.int32,
             (num_p, rf)),
            ("replica_broker", replica_broker, torch.int32, (num_r,))):
        _check(t, name, dt, shape)
    _check_vector(w, "w", num_r)
    max_h = lib.cc_swap_max_shortlist()
    if nc < 1 or nh > max_h:
        raise KernelContractError(
            f"swap_pair takes at least one cold column and at "
            f"most {max_h} hot rows")
    _check_vector(dev_u, "dev_u", num_b, broadcast=True)
    _check_vector(util, "util", num_b, broadcast=True)
    for name, t in (("lower", lower), ("upper", upper)):
        if t is not None:
            _check_vector(t, name, num_b, broadcast=True)
    vecs = (dev_u, util, lower, upper)
    if not accept.is_cuda or accept.dtype != torch.bool:
        raise KernelContractError("accept must be a bool CUDA tensor")
    acc = accept.expand(nh, nc)
    dev = w.device
    sel = torch.empty(nh, dtype=torch.float32, device=dev)
    segs = torch.empty(3 * nh, dtype=torch.int32, device=dev)
    cold_out = torch.empty(num_b, dtype=torch.int32, device=dev)
    valid_out = torch.empty(num_b, dtype=torch.bool, device=dev)
    err = lib.cc_swap_pair(
        nh, nc, rf, num_b, h_ids.data_ptr(), c_ids.data_ptr(),
        out_r.data_ptr(), in_r.data_ptr(), out_has.data_ptr(),
        in_has.data_ptr(), hot.data_ptr(), cold.data_ptr(), w.data_ptr(),
        w.stride(0), *[x for t in vecs for x in (_ptr(t), _stride(t))],
        acc.data_ptr(), acc.stride(0), acc.stride(1),
        replica_partition.data_ptr(), partition_replicas.data_ptr(),
        replica_broker.data_ptr(), sel.data_ptr(), segs.data_ptr(),
        _swap_done(dev).data_ptr(), cold_out.data_ptr(),
        valid_out.data_ptr(), _stream())
    _swap_launched("plane", err)
    return cold_out, valid_out


def _check_ids(replica_broker, replica_partition, partition_replicas):
    num_r = replica_broker.shape[0]
    _check(replica_broker, "replica_broker", torch.int32, (num_r,))
    _check(replica_partition, "replica_partition", torch.int32, (num_r,))
    if partition_replicas is not None:
        _check(partition_replicas, "partition_replicas", torch.int32,
               (partition_replicas.shape[0], partition_replicas.shape[1]))
        if partition_replicas.shape[1] > DEST_MAX_RF:
            raise KernelContractError(
                f"dest_feasibility takes RF <= {DEST_MAX_RF}, "
                f"got {partition_replicas.shape[1]}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stride(t) -> int:
    """A vector's stride; 0 for None and for a 0-d or one-entry value,
    which the kernel then reads at every index."""
    return 0 if t is None or t.numel() == 1 else t.stride(0)


def dest_pref(cand_r, dest_ids, dest_ok, replica_broker, replica_partition,
              partition_replicas, cand_has, w_c, dest_headroom, accept,
              dest_pref_b):
    """K11 launch, preference entry: f32[C, K], dest_pref_b[d] where
    cand_has[c], the structural terms, w_c[c] <= dest_headroom[d] and
    accept[c, k] hold, else NEG (analyzer/kernels.py dest_pref_plain).
    cand_r and dest_ids int32 or int64; partition_replicas may be None (no
    sibling test); cand_has, w_c (with dest_headroom) and accept may be
    None; accept is a bool plane that broadcasts to [C, K], read through
    its strides, and the float vectors are read with theirs."""
    lib = build()
    nc, nk = cand_r.shape[0], dest_ids.shape[0]
    for name, t, n in (("cand_r", cand_r, nc), ("dest_ids", dest_ids, nk)):
        if t.dtype not in (torch.int32, torch.int64):
            raise KernelContractError(
                f"{name} must be int32 or int64, got {t.dtype}")
        _check(t, name, t.dtype, (n,))
    num_b = dest_ok.shape[0]
    _check(dest_ok, "dest_ok", torch.bool, (num_b,))
    _check_ids(replica_broker, replica_partition, partition_replicas)
    rf = 0 if partition_replicas is None else partition_replicas.shape[1]
    _check_vector(dest_pref_b, "dest_pref", num_b)
    if cand_has is not None:
        _check(cand_has, "cand_has", torch.bool, (nc,))
    if (w_c is None) != (dest_headroom is None):
        raise KernelContractError(
            "dest_pref takes w_c and dest_headroom together")
    if w_c is not None:
        _check_vector(w_c, "w_c", nc)
        _check_vector(dest_headroom, "dest_headroom", num_b)
    acc_c = acc_k = 0
    if accept is not None:
        if not accept.is_cuda or accept.dtype != torch.bool:
            raise KernelContractError("accept must be a bool CUDA tensor")
        accept = accept.expand(nc, nk)
        acc_c, acc_k = accept.stride()
    out = torch.empty((nc, nk), dtype=torch.float32, device=cand_r.device)
    err = lib.cc_dest_pref(
        nc, nk, rf, cand_r.data_ptr(), int(cand_r.dtype == torch.int64),
        dest_ids.data_ptr(), int(dest_ids.dtype == torch.int64),
        dest_ok.data_ptr(), replica_broker.data_ptr(),
        replica_partition.data_ptr(), _ptr(partition_replicas),
        _ptr(cand_has), _ptr(w_c), _stride(w_c), _ptr(dest_headroom),
        _stride(dest_headroom), _ptr(accept), acc_c, acc_k,
        dest_pref_b.data_ptr(), dest_pref_b.stride(0), out.data_ptr(),
        _stream())
    LAUNCHES["dest_feasibility"] += 1
    LAUNCHES["dest_pref"] += 1
    _raise_on(err, "dest_pref")
    return out


def dest_has(cand_r, w_c, dest_ok, dest_headroom, replica_broker,
             replica_partition, partition_replicas):
    """K11 launch, guard entry: bool[C], does one of the top min(RF + 2,
    B) eligible brokers by headroom (ties to the lower id), among those
    that hold no replica of the candidate's partition, have headroom >=
    w_c?  The launch selects the brokers itself.  cand_r (int32 or int64)
    None: every replica is a candidate; w_c and dest_headroom any
    stride."""
    lib = build()
    nc = w_c.shape[0]
    num_b = dest_ok.shape[0]
    if cand_r is not None:
        if cand_r.dtype not in (torch.int32, torch.int64):
            raise KernelContractError(
                f"cand_r must be int32 or int64, got "
                f"{cand_r.dtype}")
        _check(cand_r, "cand_r", cand_r.dtype, (nc,))
    _check_vector(w_c, "w_c", nc)
    _check(dest_ok, "dest_ok", torch.bool, (num_b,))
    _check_vector(dest_headroom, "dest_headroom", num_b)
    _check_ids(replica_broker, replica_partition, partition_replicas)
    if num_b < 1:
        raise KernelContractError("dest_has takes at least one broker")
    out = torch.empty(nc, dtype=torch.bool, device=w_c.device)
    err = lib.cc_dest_has(
        nc, partition_replicas.shape[1], num_b, _ptr(cand_r),
        int(cand_r is not None and cand_r.dtype == torch.int64),
        w_c.data_ptr(), w_c.stride(0), dest_ok.data_ptr(),
        dest_headroom.data_ptr(), dest_headroom.stride(0),
        replica_broker.data_ptr(), replica_partition.data_ptr(),
        partition_replicas.data_ptr(), out.data_ptr(), _stream())
    LAUNCHES["dest_feasibility"] += 1
    LAUNCHES["dest_has"] += 1
    _raise_on(err, "dest_has")
    return out


@functools.lru_cache(maxsize=512)
def _segment_scratch_bytes(num: int, n: int, m: int) -> int:
    """Bytes of K12's one scratch allocation (its plan, from the library)."""
    nbytes = int(build().cc_segment_sum_scratch(num, n, m))
    if nbytes < 0:
        raise KernelContractError(
            f"segment_sum cannot plan N={num}, n={n}, M={m}")
    return nbytes


def segment_sum(x: torch.Tensor, ids: torch.Tensor, n: int,
                init=None) -> torch.Tensor:
    """K12 launch: f32[n, ...] per-segment sums of x (f32[N, ...]) over
    ids (int32 or int64 [N], ids outside [0, n) dropped), each adding its
    entries in index order from `init` (f32[n, ...]) or +0.0."""
    lib = build()
    num = x.shape[0]
    rest = tuple(x.shape[1:])
    _check(x, "x", torch.float32)
    if ids.dtype not in (torch.int32, torch.int64):
        raise KernelContractError(
            f"ids must be int32 or int64, got {ids.dtype}")
    _check(ids, "ids", ids.dtype, (num,))
    if init is not None:
        _check(init, "init", torch.float32, (n,) + rest)
    if not 0 <= n <= SEGMENT_MAX or num >= 2 ** 31 - 1:
        raise KernelContractError(
            f"segment_sum takes 0 <= n <= {SEGMENT_MAX} and N "
            f"< 2**31 - 1, got n={n}, N={num}")
    m = 1
    for d in rest:
        m *= d
    dev = x.device
    out = torch.empty((n,) + rest, dtype=torch.float32, device=dev)
    if n == 0 or m == 0:
        return out if init is None else init.clone()
    nbytes = _segment_scratch_bytes(num, n, m)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    err = lib.cc_segment_sum(
        x.data_ptr(), ids.data_ptr(), int(ids.dtype == torch.int64), num, n,
        m, init.data_ptr() if init is not None else None, scratch.data_ptr(),
        nbytes, int(num < SEGMENT_WARP_WALK_AVG * n), out.data_ptr(),
        _stream())
    LAUNCHES["segment_sum"] += 1
    _raise_on(err, "segment_sum")
    return out


@functools.lru_cache(maxsize=512)
def _ordered_plan(n: int, m: int, spread_rows: int) -> tuple:
    """(spread, window sums a column over the levels above 32 terms) of
    K13 for an [n, m] plane: the spread path (a block per 1,024 rows) or
    the column path (a block per column)."""
    per_col, left = 0, n
    while left > 32:
        left = -(-left // 32)
        per_col += left
    # the spread path needs a second level: more than 1,024 rows
    spread = (n > max(spread_rows, 1024)
              and -(-m // ORDERED_TILE_COLS) <= ORDERED_MAX_COLUMN_TILES)
    return spread, per_col


_ORDERED_SLOTS: dict = {}


def _ordered_slot(device: int, stream: int) -> int:
    """The counter slot of a stream of a device, for K13's spread path and
    K2's amplitude reduction (each kernel has its own set of slots): each
    stream gets its own, so that launches on two streams never share a
    counter."""
    slots = _ORDERED_SLOTS.get(device)
    if slots is None or stream not in slots:
        with _LOCK:
            slots = _ORDERED_SLOTS.setdefault(device, {})
            if stream not in slots:
                if len(slots) >= ORDERED_COUNTER_SLOTS:
                    raise KernelContractError(
                        f"more than {ORDERED_COUNTER_SLOTS} streams on device "
                        f"{device} launched K13's spread path or K2")
                slots[stream] = len(slots)
    return slots[stream]


def ordered_sum(x: torch.Tensor) -> torch.Tensor:
    """K13 launch: f32[m] column sums of x (f32[n, m]) in XLA:CPU's
    windowed order."""
    lib = build()
    if x.dim() != 2:
        raise KernelContractError(
            f"ordered_sum takes a 2-d tensor, got {x.dim()}")
    _check(x, "x", torch.float32)
    n, m = x.shape
    if n >= 2 ** 31 - 1:
        raise KernelContractError(
            f"ordered_sum takes n < 2**31 - 1, got n={n}")
    out = torch.empty(m, dtype=torch.float32, device=x.device)
    if m == 0:
        return out
    spread, per_col = _ordered_plan(n, m, ORDERED_SPREAD_ROWS)
    scratch = None
    if per_col > 0:
        scratch = torch.empty(m * per_col, dtype=torch.float32,
                              device=x.device)
    stream = _stream()
    slot = _ordered_slot(x.device.index, stream) if spread else 0
    err = lib.cc_ordered_sum(
        x.data_ptr(), n, m, scratch.data_ptr() if scratch is not None
        else None, per_col, int(spread), slot, out.data_ptr(), stream)
    LAUNCHES["ordered_sum"] += 1
    _raise_on(err, "ordered_sum")
    return out


class _GateTerms(ctypes.Structure):
    """csrc/cumsum_blocks.cu GateTerms: per term the weights (None: 1.0)
    and headrooms, each a pointer and an element stride."""
    _fields_ = [("w", _P * GATE_MAX_TERMS),
                ("w_stride", ctypes.c_longlong * GATE_MAX_TERMS),
                ("hr", _P * GATE_MAX_TERMS),
                ("hr_stride", ctypes.c_longlong * GATE_MAX_TERMS)]


def _check_vector(t: torch.Tensor, name: str, n=None,
                  broadcast: bool = False) -> None:
    """A 1-d float32 card tensor of n entries, any stride; with
    `broadcast` also a 0-d or one-entry value (read with _stride 0)."""
    scalar = broadcast and t is not None and t.dim() <= 1 and t.numel() == 1
    if (t is None or not t.is_cuda or t.dtype != torch.float32
            or t.dim() != 1 and not scalar):
        raise KernelContractError(f"{name} must be a 1-d float32 CUDA tensor")
    if n is not None and not scalar and t.shape[0] != n:
        raise KernelContractError(
            f"{name} must have {n} entries, got {t.shape[0]}")


def check_gate(k: int, n_terms: int) -> None:
    """Raise unless K14's gate takes rows of k candidates and n_terms
    terms."""
    if not 1 <= k <= GATE_MAX_K or n_terms > GATE_MAX_TERMS:
        raise KernelContractError(
            f"prefix_gate takes 1 <= k <= {GATE_MAX_K} and at "
            f"most {GATE_MAX_TERMS} terms, got k={k}, "
            f"{n_terms} terms")


def prefix_gate(has: torch.Tensor, w: torch.Tensor, excess: torch.Tensor,
                cand: torch.Tensor, terms, k: int) -> torch.Tensor:
    """K14 launch: bool[B*k], the source-side prefix gate of
    a [B, k] candidate table (analyzer/kernels.py prefix_gate_plain).
    `terms`: (weights f32[R] or None for 1.0, headroom f32[B]) pairs, any
    stride."""
    lib = build()
    num_b = excess.shape[0]
    n = num_b * k
    check_gate(k, len(terms))
    _check(has, "has", torch.bool, (n,))
    _check(w, "w", torch.float32, (n,))
    _check(cand, "cand", torch.int32, (n,))
    _check_vector(excess, "excess")
    desc = _GateTerms()
    for t, (t_w, t_hr) in enumerate(terms):
        if t_w is not None:
            _check_vector(t_w, f"terms[{t}] weights")
            desc.w[t] = t_w.data_ptr()
            desc.w_stride[t] = t_w.stride(0)
        _check_vector(t_hr, f"terms[{t}] headroom", num_b)
        desc.hr[t] = t_hr.data_ptr()
        desc.hr_stride[t] = t_hr.stride(0)
    out = torch.empty(n, dtype=torch.bool, device=w.device)
    if num_b == 0:
        return out
    err = lib.cc_prefix_gate(has.data_ptr(), w.data_ptr(), excess.data_ptr(),
                             excess.stride(0), cand.data_ptr(), num_b, int(k),
                             len(terms), ctypes.byref(desc), out.data_ptr(),
                             _stream())
    LAUNCHES["cumsum_blocks"] += 1
    _raise_on(err, "prefix_gate")
    return out
