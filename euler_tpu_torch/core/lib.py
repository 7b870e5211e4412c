"""ctypes binding of the native graph engine for the port (counterpart of
euler_tpu/core/lib.py).

The engine is the C++ of euler_tpu/core/cc/, read in place and never
edited. This module builds it itself, with the engine Makefile's flags
and link line, into

    build/euler_tpu_torch/engine/<hash>/libeuler_core.so

at the root of the checkout, where <hash> covers the sources, the
headers and the flags: a tree builds the library once, an edited source
builds a new one, and a stale one is never loaded. One g++ runs per
source, all started together (`start_build`), then one link, which
puts the C++ runtime into the library with its symbols hidden
(`LDFLAGS`). The
library of the JAX package (euler_tpu/core/libeuler_core.so) is never
loaded and its Makefile never run: the two packages hold two copies of
the engine, each with its own global RNG. A failed build raises with
the compiler's output; nothing falls back to another library.

The restype and argtypes of every symbol of the C API are declared
here (`SIGNATURES`), the same table as the reference's `_declare`.
`check` raises the port's EngineError (estimator/retry.py), so engine
failures meet the transport-marker retry rule.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional

from euler_tpu_torch.estimator.retry import EngineError

_ROOT = Path(__file__).resolve().parents[2]
ENGINE_SRC_DIR = _ROOT / "euler_tpu" / "core" / "cc"
ENGINE_BUILD_DIR = _ROOT / "build" / "euler_tpu_torch" / "engine"
# the engine Makefile's release flags and link line (euler_tpu/core/cc/
# Makefile: CXXFLAGS -O2 -fno-omit-frame-pointer, $(TARGET) -lpthread
# -ldl -lz; zlib backs rpc.cc's frame compression)
CXXFLAGS = ("-std=c++17", "-fPIC", "-O2", "-fno-omit-frame-pointer")
# The C++ runtime goes into the library, its symbols hidden
# (--exclude-libs): a toolchain that ships only libstdc++.a links it
# statically anyway, and its exported copy then mixed with the process's
# shared libstdc++.so.6 (which torch loads first): the registry's and
# shard servers' start segfaulted. Hidden, the library binds its own
# runtime whichever libstdc++ the process holds.
LDFLAGS = ("-static-libstdc++", "-static-libgcc", "-Wl,--exclude-libs,ALL")
LDLIBS = ("-lpthread", "-ldl", "-lz")
# the native self-test has its own main() and is not part of the library
_NOT_LIBRARY = ("engine_test.cc",)

_lib: Optional[ctypes.CDLL] = None


def sources() -> List[Path]:
    """The engine's library sources, sorted: every .cc of
    euler_tpu/core/cc but the self-test."""
    return sorted(p for p in ENGINE_SRC_DIR.glob("*.cc")
                  if p.name not in _NOT_LIBRARY)


def library_path() -> Path:
    """Where this tree's library lives: keyed on a hash of every source
    and header and the flags."""
    h = hashlib.sha256(" ".join(CXXFLAGS + LDFLAGS + LDLIBS).encode())
    for p in sorted(sources() + list(ENGINE_SRC_DIR.glob("*.h"))):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return ENGINE_BUILD_DIR / h.hexdigest()[:16] / "libeuler_core.so"


def find_cxx() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("no C++ compiler ($CXX or g++ on PATH): the "
                           "native graph engine cannot be built")
    return cxx


class _Build:
    """One engine build in flight: a g++ per source, started together."""

    def __init__(self, out: Path):
        self.out = out
        self.t0 = time.monotonic()
        out.parent.mkdir(parents=True, exist_ok=True)
        self.tmp = Path(tempfile.mkdtemp(prefix=".objs-", dir=out.parent))
        self.cxx = find_cxx()
        self.jobs = []
        for src in sources():
            obj = self.tmp / (src.stem + ".o")
            proc = subprocess.Popen(
                [self.cxx, *CXXFLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            self.jobs.append((src.name, obj, proc))

    def wait(self) -> dict:
        """Wait for the compiles, link, and move the library into place.
        Returns {"seconds", "sources"}; raises with the compiler's output
        on a failure."""
        try:
            failed = []
            for name, _, proc in self.jobs:
                log = proc.communicate()[0]
                if proc.returncode != 0:
                    failed.append(f"{name}: g++ exited {proc.returncode}\n"
                                  f"{log}")
            if failed:
                raise RuntimeError("native engine build failed:\n"
                                   + "\n".join(failed))
            lib_tmp = self.tmp / "libeuler_core.so"
            link = subprocess.run(
                [self.cxx, *CXXFLAGS, "-shared", *LDFLAGS, "-o",
                 str(lib_tmp), *(str(o) for _, o, _ in self.jobs), *LDLIBS],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            if link.returncode != 0:
                raise RuntimeError(
                    "native engine link failed (it links "
                    f"{' '.join(LDLIBS)}; -lz needs zlib's development "
                    f"library): g++ exited {link.returncode}\n"
                    f"{link.stdout}")
            os.replace(lib_tmp, self.out)  # a reader never sees a partial
        finally:
            for _, _, proc in self.jobs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
            shutil.rmtree(self.tmp, ignore_errors=True)
        return {"seconds": time.monotonic() - self.t0,
                "sources": len(self.jobs)}


class _Built:
    def wait(self) -> dict:
        return {"seconds": 0.0, "sources": 0}


def start_build():
    """Start building the library unless this tree's exists; `.wait()`
    on the result finishes the build and returns {"seconds": wall
    seconds (0.0 when it existed), "sources": compiles run}."""
    out = library_path()
    if out.is_file():
        return _Built()
    return _Build(out)


def build() -> dict:
    return start_build().wait()


c_u64p = ctypes.POINTER(ctypes.c_uint64)
c_i64p = ctypes.POINTER(ctypes.c_int64)
c_i32p = ctypes.POINTER(ctypes.c_int32)
c_f32p = ctypes.POINTER(ctypes.c_float)
c_voidp = ctypes.c_void_p

_i64, _i32, _u64, _f32 = (ctypes.c_int64, ctypes.c_int, ctypes.c_uint64,
                          ctypes.c_float)
_str = ctypes.c_char_p
_nbr_sig = (_i32, [_i64, c_u64p, _i64, c_i32p, _i64, _i64, _u64, c_u64p,
                   c_f32p, c_i32p])
_delta_sig = (_i32, [_i64, _i64, c_u64p, c_i32p, c_f32p, _i64, c_u64p,
                     c_u64p, c_i32p, c_f32p, c_i64p])

# symbol → (restype, argtypes), as euler_tpu/core/lib.py:_declare gives
# them: every symbol of the engine's C API, name for name
SIGNATURES: Dict[str, tuple] = {
    "etg_last_error": (_str, []),
    "etg_seed": (None, [_u64]),
    "etg_builder_new": (_i64, []),
    "etg_builder_set_feature": (_i32, [_i64, _i32, _i32, _i32, _i64, _str]),
    "etg_builder_set_num_types": (_i32, [_i64, _i32, _i32]),
    "etg_builder_set_type_name": (_i32, [_i64, _i32, _i32, _str]),
    "etg_type_id": (_i32, [_i64, _i32, _str]),
    "etg_type_name": (_i32, [_i64, _i32, _i32, _str, _i64]),
    "etg_builder_add_nodes": (_i32, [_i64, _i64, c_u64p, c_i32p, c_f32p]),
    "etg_builder_add_edges": (_i32, [_i64, _i64, c_u64p, c_u64p, c_i32p,
                                     c_f32p]),
    "etg_builder_set_node_dense": (_i32, [_i64, c_u64p, _i64, _i32, _i64,
                                          c_f32p]),
    "etg_builder_set_node_sparse": (_i32, [_i64, c_u64p, _i64, _i32,
                                           c_u64p, c_u64p]),
    "etg_builder_set_node_binary": (_i32, [_i64, _u64, _i32, _str, _i64]),
    "etg_builder_set_edge_dense": (_i32, [_i64, c_u64p, c_u64p, c_i32p,
                                          _i64, _i32, _i64, c_f32p]),
    "etg_builder_set_edge_sparse": (_i32, [_i64, _u64, _u64, _i32, _i32,
                                           c_u64p, _i64]),
    "etg_builder_set_edge_binary": (_i32, [_i64, _u64, _u64, _i32, _i32,
                                           _str, _i64]),
    "etg_builder_set_graph_labels": (_i32, [_i64, c_u64p, c_u64p, _i64]),
    "etg_builder_finalize": (_i64, [_i64, _i32]),
    "etg_load": (_i64, [_str, _i32, _i32, _i32, _i32]),
    "etg_dump": (_i32, [_i64, _str, _i32, _i32]),
    "etg_free": (_i32, [_i64]),
    "etg_node_count": (_i64, [_i64]),
    "etg_edge_count": (_i64, [_i64]),
    "etg_num_node_types": (_i32, [_i64]),
    "etg_num_edge_types": (_i32, [_i64]),
    "etg_num_node_features": (_i32, [_i64]),
    "etg_num_edge_features": (_i32, [_i64]),
    "etg_feature_info": (_i32, [_i64, _i32, _i32, c_i32p, c_i64p, _str,
                                _i64]),
    "etg_all_node_ids": (_i32, [_i64, c_u64p]),
    "etg_node_rows": (_i32, [_i64, c_u64p, _i64, _i32, c_i32p]),
    "etg_graph_label_count": (_i64, [_i64]),
    "etg_sample_graph_label": (_i32, [_i64, _i64, c_u64p]),
    "etg_get_graph_by_label": (_i32, [_i64, c_u64p, _i64, c_voidp]),
    "etg_all_node_weights": (_i32, [_i64, c_f32p]),
    "etg_node_weight_sums": (_i32, [_i64, c_f32p]),
    "etg_edge_weight_sums": (_i32, [_i64, c_f32p]),
    "etg_sample_node": (_i32, [_i64, _i32, _i64, c_u64p]),
    "etg_sample_node_with_types": (_i32, [_i64, c_i32p, _i64, c_u64p]),
    "etg_sample_edge": (_i32, [_i64, _i32, _i64, c_u64p, c_u64p, c_i32p]),
    "etg_get_node_type": (_i32, [_i64, c_u64p, _i64, c_i32p]),
    "etg_sample_neighbor": _nbr_sig,
    "etg_sample_in_neighbor": _nbr_sig,
    "etg_get_top_k_neighbor": _nbr_sig,
    "etg_sample_fanout": (_i32, [_i64, c_u64p, _i64, c_i32p, _i64, c_i32p,
                                 c_i64p, _u64, ctypes.POINTER(c_u64p),
                                 ctypes.POINTER(c_f32p),
                                 ctypes.POINTER(c_i32p)]),
    "etg_random_walk": (_i32, [_i64, c_u64p, _i64, _i64, _f32, _f32, _u64,
                               c_i32p, _i64, c_u64p]),
    "etg_sample_layerwise": (_i32, [_i64, c_u64p, _i64, c_i32p, _i64,
                                    c_i32p, _i64, _u64, _i32,
                                    ctypes.POINTER(c_u64p)]),
    "etg_get_dense_feature": (_i32, [_i64, c_u64p, _i64, _i32, _i64,
                                     c_f32p]),
    "etg_get_edge_dense_feature": (_i32, [_i64, c_u64p, c_u64p, c_i32p,
                                          _i64, _i32, _i64, c_f32p]),
    "etres_new": (c_voidp, []),
    "etres_free": (None, [c_voidp]),
    "etres_offsets_len": (_i64, [c_voidp]),
    "etres_offsets": (c_u64p, [c_voidp]),
    "etres_u64_len": (_i64, [c_voidp]),
    "etres_u64": (c_u64p, [c_voidp]),
    "etres_f32_len": (_i64, [c_voidp]),
    "etres_f32": (c_f32p, [c_voidp]),
    "etres_i32_len": (_i64, [c_voidp]),
    "etres_i32": (c_i32p, [c_voidp]),
    "etres_bytes_len": (_i64, [c_voidp]),
    "etres_bytes": (ctypes.POINTER(ctypes.c_char), [c_voidp]),
    "etg_get_full_neighbor": (_i32, [_i64, c_u64p, _i64, c_i32p, _i64, _i32,
                                     _i32, c_voidp]),
    "etg_get_sparse_feature": (_i32, [_i64, c_u64p, _i64, _i32, c_voidp]),
    "etg_get_binary_feature": (_i32, [_i64, c_u64p, _i64, _i32, c_voidp]),
    "etg_get_edge_sparse_feature": (_i32, [_i64, c_u64p, c_u64p, c_i32p,
                                           _i64, _i32, c_voidp]),
    "etg_get_edge_binary_feature": (_i32, [_i64, c_u64p, c_u64p, c_i32p,
                                           _i64, _i32, c_voidp]),
    "etg_graph_epoch": (_i64, [_i64]),
    "etg_apply_delta": _delta_sig,
    "etg_delta_since": (_i32, [_i64, _i64, c_voidp, c_i64p, c_i32p]),
    "etg_hash64": (_u64, [_str, _u64]),
    "etg_set_log_level": (None, [_i32]),
    # the query layer (gql.py): proxies, their executions and stats
    "etq_new_local": (_i64, [_i64, _str, _u64]),
    "etq_new_remote": (_i64, [_str, _u64, _str]),
    "etq_free": (_i32, [_i64]),
    "etq_stats": (_i32, [_i64, c_u64p]),
    "etq_index_dump": (_i32, [_i64, _str]),
    "etq_epoch": (_i64, [_i64]),
    "etq_apply_delta": _delta_sig,
    "etq_delta_since": (_i32, [_i64, _i64, c_voidp, c_i64p, c_i32p]),
    "etq_exec_new": (_i64, [_i64]),
    "etq_exec_add_input": (_i32, [_i64, _str, _i32, _i32, c_i64p, c_voidp]),
    "etq_exec_run": (_i32, [_i64, _str]),
    "etq_exec_output_count": (_i64, [_i64]),
    "etq_exec_output_name": (_str, [_i64, _i64]),
    "etq_exec_output_info": (_i32, [_i64, _i64, c_i32p, c_i32p, c_i64p]),
    "etq_exec_output_dims": (_i32, [_i64, _i64, c_i64p]),
    "etq_exec_output_data": (c_voidp, [_i64, _i64]),
    "etq_exec_free": (_i32, [_i64]),
    "etq_compile_debug": (_i64, [_str, _i32, _i32, _str, _str, _i64]),
    "etq_compile_debug2": (_i64, [_str, _i32, _i32, _str, _i32, _str,
                                  _i64]),
    # value UDFs and their result cache
    "etg_register_udf": (None, [_str, c_voidp]),
    "et_udf_emit": (None, [c_voidp, c_u64p, _i64, c_f32p, _i64]),
    "etg_udf_cache_stats": (None, [ctypes.POINTER(_u64)] * 4),
    "etg_udf_cache_clear": (None, []),
    "etg_udf_cache_set_capacity": (None, [_u64]),
    "etg_udf_cache_epoch_evictions": (_u64, []),
    # the RPC transport's process-global config and client-edge counters
    # (37 u64s), the per-thread deadline and trace handoffs, the
    # server-side timing histograms and span ring
    "etg_rpc_config": (None, [_i32, _i32, _i64, _i32, _i64, _i32, _i32,
                              _i32, _i32, _i32, _i32, _i64, _i32]),
    "etg_rpc_stats": (None, [c_u64p]),
    "etg_set_call_deadline_ms": (None, [ctypes.c_double]),
    "etg_set_call_trace": (None, [_u64, _u64]),
    "etg_server_trace_hist": (_i32, [_i32, _i32, c_u64p]),
    "etg_server_trace_dump": (_i32, [c_voidp]),
    # ownership maps (elastic fleet)
    "etg_push_ownership": (_i32, [_str, _i32, _str, c_i64p]),
    "etq_set_ownership": (_i32, [_i64, _str]),
    "etq_ownership_epoch": (_i64, [_i64]),
    "etq_shard_num": (_i32, [_i64]),
    "etq_shard_stats": (_i32, [_i64, c_u64p, c_u64p, _i32]),
    "ets_set_ownership": (_i32, [_i64, _str]),
    "ets_map_epoch": (_i64, [_i64]),
    # shard servers (ets_start2 adds the WAL, ets_start3 the storage
    # tier), the WAL and store counters, the registry server
    "ets_start": (_i64, [_str, _i32, _i32, _i32, _str, _str, _str]),
    "ets_start2": (_i64, [_str, _i32, _i32, _i32, _str, _str, _str, _str,
                          _i32, _i64, _i32]),
    "ets_start3": (_i64, [_str, _i32, _i32, _i32, _str, _str, _str, _str,
                          _i32, _i64, _i32, _i32, _i64]),
    "ets_epoch": (_i64, [_i64]),
    "ets_port": (_i32, [_i64]),
    "ets_stop": (_i32, [_i64]),
    "ets_plan_debug": (_i64, [_i64, _str, _i64]),
    "etg_wal_stats": (None, [c_u64p]),
    "etg_store_write": (_i32, [_i64, _str]),
    "etg_store_open": (_i64, [_str, _i64]),
    "etg_store_stats": (None, [c_u64p]),
    "etr_start": (_i64, [_i32]),
    "etr_port": (_i32, [_i64]),
    "etr_stop": (_i32, [_i64]),
    "etr_scan": (_i64, [_str, _str, _i64]),
}


def _declare(lib) -> None:
    for name, (restype, argtypes) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes


def load() -> ctypes.CDLL:
    """The port's engine library, built first if this tree has none."""
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(str(library_path()))
        _declare(lib)
        _lib = lib
    return _lib


def check(lib: ctypes.CDLL, rc: int) -> None:
    if rc != 0:
        raise EngineError(lib.etg_last_error().decode())
