"""Graph data prep: JSON → partitioned binary graph (copy of
euler_tpu/tools/generate_data.py; tests/test_torch_data.py holds its
bytes to the original's).

Parity: euler/tools/generate_euler_data.py:28-50 (EulerGenerator =
json2meta + json2partdat) — accepts the same graph.json schema as the
reference (nodes: id/type/weight/features[{name,type,value}], edges:
src/dst/type/weight/features) and writes the engine's binary layout
(meta.bin + part_p.dat, format in euler_tpu/core/cc/io.h), which
the port's GraphEngine.load and dataset.load_named read. Partition
assignment: hash(node_id) % num_partitions; an edge lives in its source
node's partition (reference json2partdat behavior).

Usage:
  python -m euler_tpu_torch.tools.generate_data graph.json out_dir 2
"""

from __future__ import annotations

import json
import struct
import sys
from collections import defaultdict
from typing import Dict, List

MAGIC_PART = b"ETP1"
MAGIC_META = b"ETM1"
VERSION = 1

KIND_DENSE, KIND_SPARSE, KIND_BINARY = 0, 1, 2
_KIND_BY_NAME = {"dense": KIND_DENSE, "float": KIND_DENSE,
                 "sparse": KIND_SPARSE, "uint64": KIND_SPARSE,
                 "binary": KIND_BINARY, "string": KIND_BINARY}


def _feature_registry(items: List[dict], reg: Dict[str, dict]) -> None:
    for obj in items:
        for f in obj.get("features", []):
            name = f["name"]
            kind = _KIND_BY_NAME.get(f.get("type", "dense"), KIND_DENSE)
            if name not in reg:
                reg[name] = {"id": len(reg), "kind": kind, "dim": 0}
            if kind == KIND_DENSE:
                reg[name]["dim"] = max(reg[name]["dim"],
                                       len(f.get("value", [])))
            elif kind == KIND_SPARSE:
                reg[name]["dim"] = max(reg[name]["dim"],
                                       len(f.get("value", [])))


def _pack_str(s: str) -> bytes:
    raw = s.encode()
    return struct.pack("<I", len(raw)) + raw


def _pack_feats(feats: List[dict], reg: Dict[str, dict]) -> bytes:
    dense, sparse, binary = [], [], []
    for f in feats:
        info = reg[f["name"]]
        fid = info["id"]
        val = f.get("value", [])
        if info["kind"] == KIND_DENSE:
            dense.append((fid, [float(v) for v in val]))
        elif info["kind"] == KIND_SPARSE:
            sparse.append((fid, [int(v) for v in val]))
        else:
            raw = val if isinstance(val, str) else "".join(map(str, val))
            binary.append((fid, raw.encode()))
    out = [struct.pack("<H", len(dense))]
    for fid, v in dense:
        out.append(struct.pack("<HI", fid, len(v)))
        out.append(struct.pack(f"<{len(v)}f", *v))
    out.append(struct.pack("<H", len(sparse)))
    for fid, v in sparse:
        out.append(struct.pack("<HI", fid, len(v)))
        out.append(struct.pack(f"<{len(v)}Q", *v))
    out.append(struct.pack("<H", len(binary)))
    for fid, raw in binary:
        out.append(struct.pack("<HI", fid, len(raw)))
        out.append(raw)
    return b"".join(out)


def convert(json_path: str, out_dir: str, num_partitions: int = 1) -> dict:
    import os

    os.makedirs(out_dir, exist_ok=True)
    with open(json_path) as f:
        g = json.load(f)
    nodes = g.get("nodes", [])
    edges = g.get("edges", [])

    node_reg: Dict[str, dict] = {}
    edge_reg: Dict[str, dict] = {}
    _feature_registry(nodes, node_reg)
    _feature_registry(edges, edge_reg)

    # type name → id maps (types may be ints already or strings)
    def type_id(val, table: Dict) -> int:
        key = str(val)
        if key not in table:
            table[key] = len(table)
        return table[key]

    node_types: Dict[str, int] = {}
    edge_types: Dict[str, int] = {}

    def node_id(val) -> int:
        # string ids hash to u64 (reference parity: the json tools map
        # string node ids through py_hash64, euler/util/python_api.cc)
        if isinstance(val, str) and not val.lstrip("-").isdigit():
            from euler_tpu_torch.utils import hash64

            return hash64(val)
        return int(val)

    part_nodes = defaultdict(list)
    part_edges = defaultdict(list)
    for nd in nodes:
        nid = node_id(nd["id"])
        p = nid % num_partitions
        rec = struct.pack("<Qif", nid, type_id(nd.get("type", 0), node_types),
                          float(nd.get("weight", 1.0)))
        rec += _pack_feats(nd.get("features", []), node_reg)
        part_nodes[p].append(rec)
    for ed in edges:
        src = node_id(ed.get("src", ed.get("src_id", 0)))
        dst = node_id(ed.get("dst", ed.get("dst_id", 0)))
        p = src % num_partitions
        rec = struct.pack("<QQif", src, dst,
                          type_id(ed.get("type", 0), edge_types),
                          float(ed.get("weight", 1.0)))
        rec += _pack_feats(ed.get("features", []), edge_reg)
        part_edges[p].append(rec)

    for p in range(num_partitions):
        with open(os.path.join(out_dir, f"part_{p}.dat"), "wb") as f:
            f.write(MAGIC_PART)
            f.write(struct.pack("<I", VERSION))
            f.write(struct.pack("<Q", len(part_nodes[p])))
            for rec in part_nodes[p]:
                f.write(rec)
            f.write(struct.pack("<Q", len(part_edges[p])))
            for rec in part_edges[p]:
                f.write(rec)

    # meta.bin
    nt = max(len(node_types), 1)
    et = max(len(edge_types), 1)
    with open(os.path.join(out_dir, "meta.bin"), "wb") as f:
        f.write(MAGIC_META)
        f.write(struct.pack("<IIII", VERSION, nt, et, num_partitions))
        f.write(struct.pack("<QQ", len(nodes), len(edges)))
        f.write(_pack_str(g.get("name", "graph")))
        names = sorted(node_types, key=node_types.get) or ["0"]
        f.write(struct.pack("<I", len(names)))
        for n in names:
            f.write(_pack_str(n))
        names = sorted(edge_types, key=edge_types.get) or ["0"]
        f.write(struct.pack("<I", len(names)))
        for n in names:
            f.write(_pack_str(n))
        for reg in (node_reg, edge_reg):
            items = sorted(reg.items(), key=lambda kv: kv[1]["id"])
            f.write(struct.pack("<I", len(items)))
            for name, info in items:
                f.write(_pack_str(name))
                f.write(struct.pack("<iq", info["kind"], info["dim"]))
    return {"nodes": len(nodes), "edges": len(edges),
            "partitions": num_partitions,
            "node_features": len(node_reg), "edge_features": len(edge_reg)}


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 2:
        print(__doc__)
        return 1
    stats = convert(argv[0], argv[1],
                    int(argv[2]) if len(argv) > 2 else 1)
    print(json.dumps(stats))
    return 0


if __name__ == "__main__":
    sys.exit(main())
