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
SOURCES = ("row_topk.cu", "assign_pass.cu", "commit_moves.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES = {"row_topk": 0, "assign_pass": 0, "commit_moves": 0}

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
        lib.cc_row_topk.argtypes = [_P, _P, _I, _I, _I, _P, _P, _P, _P]
        lib.cc_assign_pass.argtypes = [_P, _P, _P, _P, _I, _I, _I, _P, _P,
                                       _P, _P]
        lib.cc_commit_moves.argtypes = [_I] * 7 + [_P] * 31 + [_P]
        for fn in (lib.cc_row_topk, lib.cc_assign_pass, lib.cc_commit_moves):
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
    """K1 launch: (cand i32[B*k], has bool[B*k], top f32[B, k])."""
    lib = build()
    b, s = sc_rows.shape
    if not 1 <= k <= min(8, s):
        raise ValueError(f"row_topk takes 1 <= k <= min(8, S), got k={k}")
    _check(sc_rows, "sc_rows", torch.float32)
    _check(table, "table", torch.int32, (b, s))
    cand = torch.empty(b * k, dtype=torch.int32, device=sc_rows.device)
    has = torch.empty(b * k, dtype=torch.bool, device=sc_rows.device)
    top = torch.empty((b, k), dtype=torch.float32, device=sc_rows.device)
    err = lib.cc_row_topk(sc_rows.data_ptr(), table.data_ptr(), b, s, k,
                          cand.data_ptr(), has.data_ptr(), top.data_ptr(),
                          _stream())
    LAUNCHES["row_topk"] += 1
    _raise_on(err, "row_topk")
    return cand, has, top


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


#: the cache fields K3 writes; `commit_moves` hands the kernel copies
COMMIT_FIELDS = ("broker_load", "replica_count", "leader_count",
                 "partition_rack_count", "broker_topic_count",
                 "potential_nw_out", "leader_bytes_in", "broker_table",
                 "table_fill", "table_load", "table_bonus", "table_leader",
                 "table_ok")


def commit_moves(state_before, cache, r: torch.Tensor, dst: torch.Tensor,
                 valid: torch.Tensor, rank: torch.Tensor) -> dict:
    """K3: the cache fields after committing the batch (fresh tensors; the
    inputs are not modified)."""
    out = {f: getattr(cache, f).clone() for f in COMMIT_FIELDS}
    out["broker_util"] = torch.empty_like(cache.broker_load)
    commit_moves_into(out, state_before, cache, r, dst, valid, rank)
    return out


def commit_moves_into(out: dict, state_before, cache, r: torch.Tensor,
                      dst: torch.Tensor, valid: torch.Tensor,
                      rank: torch.Tensor) -> None:
    """K3 launch into `out`, which holds a copy of each of the cache's
    COMMIT_FIELDS (updated in place) and a `broker_util` plane (written);
    `cache.table_fill` is read as the fill before the batch."""
    lib = build()
    n = r.shape[0]
    num_b = state_before.num_brokers
    num_r = state_before.num_replicas
    sw = cache.broker_table.shape[1]
    if sw == 0:
        raise ValueError("commit_moves needs a broker table")
    for name, t, dt, shape in (
            ("r", r, torch.int32, (n,)), ("dst", dst, torch.int32, (n,)),
            ("valid", valid, torch.bool, (n,)),
            ("rank", rank, torch.int32, (n,)),
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
    for f in (*COMMIT_FIELDS, "broker_util"):
        like = cache.broker_load if f == "broker_util" else getattr(cache, f)
        _check(out[f], f"out[{f!r}]", like.dtype, like.shape)
    # the kernel reads the fill before the batch while it counts arrivals
    if out["table_fill"].data_ptr() == cache.table_fill.data_ptr():
        raise ValueError("out['table_fill'] must be a copy of the cache's")
    # per-move scratch: the float contribution row and the two ends
    contrib = torch.empty((n, 8), dtype=torch.float32, device=r.device)
    ends = torch.empty((2, n), dtype=torch.int32, device=r.device)
    s = state_before
    err = lib.cc_commit_moves(
        n, num_b, sw, num_r, s.num_racks, s.num_topics,
        cache.replica_ok.shape[0],
        r.data_ptr(), dst.data_ptr(), valid.data_ptr(), rank.data_ptr(),
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
        out["leader_bytes_in"].data_ptr(), out["broker_table"].data_ptr(),
        cache.table_fill.data_ptr(), out["table_fill"].data_ptr(),
        out["table_load"].data_ptr(), out["table_bonus"].data_ptr(),
        out["table_leader"].data_ptr(), out["table_ok"].data_ptr(),
        contrib.data_ptr(), ends.data_ptr(), _stream())
    LAUNCHES["commit_moves"] += 1
    _raise_on(err, "commit_moves")
