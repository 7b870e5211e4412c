#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (euler_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--out PATH] [--baseline-source PATH]
                          [--extra-loop-k K ...]

The GraphSAGE path at the width of bench.py's flagship configuration
(bench.py:776-869): a products-like graph (2.45M nodes, average degree
50, 16 classes, 100-dim features quantized to int8 with a bfloat16
per-column scale, neighbor cap 32) loaded into the port's build of the
native graph engine, the tables read from it as bench.py's rebuild path
reads them (bench.py:334-366), DeviceSampledGraphSage with dim 128
and fanouts [15, 10] and random seeded weights, root batches of 32768;
then the unsupervised family on the same graph (unsupervised GraphSAGE
and the DeepWalk skip-gram of bench.py --walk); then the fused and alias
table layouts and the activation cache (bench.py --fused_sampler,
--alias_sampler, --act_cache) on the same graph; then the host-fed path
of bench.py --host_sampler (the engine samples the fanout on the host);
then the layerwise family of bench.py --layerwise on the same tables and
full-batch message passing (GCN, GAT) on the pubmed stand-in; then graph
classification on the mutag stand-in and GAE, DGI and LGCN on cora at
their runners' widths; then the rest of the node zoo (host-fed GeniePath
and ScalableGraphSage, the solutions) on cora and the knowledge-graph
family (TransE/H/R/D, DistMult, R-GCN) on the fb15k237 stand-in, with
RelationConv and GroupGNNNet on cora; then graphs that change:
StreamingDriver deltas on the flagship's engine, the neighbor table
patched row by row on the card, the loop captured again, a fresh bundle
swapped into a server, growth, and the reference's acceptance round;
then the serving stack over bundles exported from the trained flagship
(2,450,000 x 256 f32); and the graph service: the flagship's host-fed
step trained from a 2-shard cluster of its own graph, found through a
tcp: registry.
Phases, in order; any failure raises and the exit code is not 0:

  1. device   the card's name and power limit (nvidia-smi); TF32 off
  2. build    nvcc builds every kernel under euler_tpu_torch/csrc; ptxas
              registers and spills per kernel (a spill fails the run);
              beside it, g++ builds the graph engine from
              euler_tpu/core/cc (one job a source), its seconds printed
  3. graph    synthetic arrays → the graph engine (build_engine) →
              DeviceNeighborTable(graph, cap 32) and DeviceFeatureStore(
              graph, int8, bfloat16 scale) on the card; the engine's
              node and edge counts and the seconds of each step
  4. kernels  gather_mean against its plain version at the path's shapes
              (int8 + bf16 scale, int8 + f32 scale, f32 table), the cora
              runner's (n 640, D 1433, int8 + f32 scale) and the path's
              int8 table one byte off alignment; per case its launch
              plan, time, GB/s and share of the bound, the plain
              version's time, embedding_bag's and the bound; a sweep of
              launch plans on the main case
  5. slice    the inference sweep over every node (75 batches) through
              the kernel (launch count checked), finite outputs, kernel
              forward vs plain forward
  6. train    NodeEstimator.train with Adam (lr 0.01) on the same
              tables: 5 warm-up steps, 30 timed steps in 3 windows
              (bench.py:883-911), then 10 event-timed steps; edges/s,
              one profiled step, launches == steps, a finite falling
              loss, no skipped step; one remat=True step against the
              plain step (same loss, gradients, 2 launches); then
              export v1: export_bundle from that estimator (the sweep,
              gather_mean once per forward, 75; save with sha256,
              index off), and a verified load
  7. loop     the same training at steps_per_loop = 32 (bench.py's K,
              bench.py:41-44), fed by bench.py's prefetch thread (depth
              3): K + 2 warm-up steps (the first window eager, then the
              capture of the 32-step CUDA graph, then a tail of 2), 3
              timed windows of 64 steps (two replays each); edges/s,
              host ms per step, ms per replay (events), busy share from
              one profiled replay (32 gather_mean kernels in it), peak
              memory, and launches: eager launches + launches recorded
              per window x replays == steps. Then the graph against
              eager steps at the same shapes: 3 windows of 32 from the
              same weights and batches at K = 32 and at K = 1 give the
              same losses, parameters and Adam moments, bit for bit;
              export v2 from the K = 32 estimator, as after phase 6
  8. unsup    unsupervised GraphSAGE (DeviceSampledUnsupervisedSage,
              5 negatives drawn over every node) at the flagship's
              width on the same tables, in a plain BaseEstimator: K = 1
              as phase 6, K = 32 as phase 7 (edges/s, roots/s, host ms
              per step, busy share, peak memory, loss, MRR, launches ==
              steps), then the graph against eager steps at K = 8, bit
              for bit
  9. walk     the DeepWalk skip-gram (DeviceSampledSkipGram) at bench.py
              --walk's shape (bench.py:392-503: walk_len 5, window 1/1,
              5 negatives, dim 128, K = 8): pairs/s (bench.py's metric),
              ms per replay, host ms per step, busy share, peak memory,
              dense Adam's bytes against the step; the graph against
              eager steps at K = 8, bit for bit; then whether
              F.embedding's dense backward repeats bit for bit
 9a. layouts  the fused [N+1, 64] and alias [N+1, 32] layouts of the
              phase-3 table (its host copy, not built again):
              fuse_tables_host and build_alias_tables timed, bytes on
              the card; 10^7 alias draws on a seeded weighted table at
              count 32 and at count 1 against its weights (chi-squared,
              p = 0.001), the card's picks equal to the CPU's for the
              same uniforms
 9b. fused    the flagship over the fused table at K = 32 as phase 7
              (edges/s, ms a step, launches == steps), the graph against
              eager steps, and against the split tables' weighted draw
              over the same batches, bit for bit
 9c. alias    the same over the alias layout (bench.py --alias_sampler)
 9d. cache    the activation cache at bench.py --act_cache's shape
              (DeviceSampledScalableSage dim 128, one hop of 15, 2
              layers, a bfloat16 cache over every row): K = 1 and K = 32
              (nodes/s, edges/s at 2 x B x 15 a step, 2 gather_mean
              launches a step), refresh_act_cache over all rows in
              8192-row chunks (seconds, launches), the graph against
              eager steps at K = 32 with the caches, bit for bit
 9e. alias family  unsupervised GraphSAGE and DeepWalk over the alias
              layout, the graph against eager steps at K = 8
 9f. host-fed bench.py --host_sampler's path (bench.py:821-869):
              FanoutDataFlow(graph, [15, 10]) on the host, rows into the
              int8 table, SupervisedGraphSage dim 128, batch 32768, Adam
              lr 0.01, K = 1: 2 warm-up and 5 timed steps; edges/s, ms a
              step, host ms a batch (root draw, sample_fanout, lookup),
              busy share, a finite falling loss, no gather_mean launch;
              one step of the host-arrays path (the engine's features)
 9g. layerwise  bench.py --layerwise (bench.py:513-585) on the phase-3
              tables: DeviceSampledLayerwiseGCN dim 128, batch 512,
              pools (512, 512), Adam lr 0.01, fed by the prefetch
              thread; K = 1 as phase 6 and K = 32 with 2 timed windows
              (pool-nodes/s, ms a step, host ms a step, busy share,
              peak memory, a finite falling loss, gather_mean launches
              0); the dense adjacency's ms and share of a step and the
              memory it allocates; the graph against eager steps at
              K = 32, bit for bit; then K = 32 and the same check over
              phase 9a's alias table
 9h. fullbatch  the runners' GCN and GAT (8 heads) over
              FullBatchDataFlow on the pubmed stand-in: one step on the
              card against the CPU (loss rtol 1e-4, gradients 1e-5 of
              the largest), then 20 timed steps: ms a step, the host's
              batch build and host-to-device copy shares, busy share
 9i. zoo      slice 10 at the runners' default widths: the four mutag
              runners' GraphModels (gin + sum, gcn + sum of 4 layers of
              64, gated + attention, gin + set2set; GraphEstimator, 16
              graphs a batch), GAE and VGAE (a fixed eps) over
              FullBatchDataFlow on cora, DGI (dim 512, cora's whole
              graph on the card, one corruption a step) and LGCN (host
              FanoutDataFlow, fanout 30, k 8): each one step on the card
              against the CPU (loss rtol 1e-4, gradients 1e-5 of the
              largest; DGI's PReLUs take the CPU's side of the kink,
              the flips counted), then 20 timed steps: ms a step, the
              host's batch build and its share, busy share, a finite
              loss, no gather_mean launch; run_gin's dropout steps
              twice, bit for bit
 9j. slice 11 at the runners' default widths: host-fed GeniePath
              (fanouts 15, 10, dim 64) and ScalableGraphSage (one hop
              of 10, dim 32, its float32 cache read by gather_mean: one
              launch a step) on cora; SuperviseSolution and
              UnsuperviseSolution (dot, cosine) on cora; TransE, TransH,
              TransR, TransD and DistMult (dim 64, 256 triples, 16
              negatives) and RGCNLinkModel (dim 32, 8 relations x
              fanout 8) on the fb15k237 stand-in; RelationConv inside
              BaseGNNNet and GroupGNNNet over cora's whole graph with 4
              synthetic relations (an edge's source row mod 4; groups
              by its parity): each one step on the card against the CPU
              (loss rtol 1e-4, gradients 1e-5 of the largest;
              ScalableGraphSage after one training step, so the
              compared step reads the cache the first wrote), then 20
              timed steps: ms a step, the host's batch build and its
              share, busy share, gather_mean launches (1 a step on
              ScalableGraphSage, 0 elsewhere); TransE and the R-GCN
              runner's steps twice, bit for bit
 9k. streaming  graphs that change, on the flagship's engine and its
              table (host copy kept). (a) and (c) run right after phase
              3, beside the quality workers, since the engine rebuilds
              its whole snapshot for a delta (every later phase runs on
              the patched graph and table): (a) a K = 32 estimator
              captures a window and exports the phase's first bundle,
              which an InferenceServer on the card loads; 65,536 new
              weight-1 edges between existing nodes go through
              StreamingDriver.apply_delta (engine seconds; patch_rows
              ms, rows, "row_scatter"); the patch binds new tensors:
              untouched rows bit-equal to a clone taken before, dirty
              rows equal to the rows re-derived from the engine's lists,
              card == host; the estimator replays over the old tensors,
              then captures again after static_batch.update(
              table.tables); graph against eager on the patched table
              bit for bit; export_and_swap: the served rows of dirty
              nodes the new bundle's; counters 1 delta, 1 export, 1
              swap, alias_rows_patched_total == rows patched; (c) the
              reference's acceptance round (tests/test_streaming.py:
              752-827) with the estimator and the server on the card:
              v2 served with one more id, its kNN returning the node
              that did not exist at train start. (b) after phase 9g,
              the last reader of the flagship's engine, 4,096 new nodes
              with 8 edges each and their reverses go into the engine
              on a thread of its own beside phases 9h-12; after phase
              12 the table is patched: "replace", the old rows' pad
              sentinels remapped, card == host
 9l. graph service  after phase 9f, on the graph as 9k (a) and (c) left
              it: the engine dumped as 2 partitions (build/
              chip_smoke_cluster, removed at the end), a tcp: registry
              (gql.start_registry) and 2 shards (gql.start_service),
              set up on a thread of their own from phase 7 on (dump and
              load seconds, RSS, each shard's node and edge counts from
              its own meta, summing to the engine's); a RemoteGraphEngine
              found through the registry (a pool of 8) under a
              CachedGraphEngine: on 4,096 seeded ids the remote and the
              cached (cold, warm) full neighbor lists, dense features
              and node types byte-equal to the embedded engine's, a
              remote [15, 10] fanout only true neighbors, the warm read
              all hits, a degraded fetch not cached; then 9f's step
              trained from the cluster (FanoutDataFlow over the cache,
              rows from the embedded engine's lookup) with
              feeder_workers 0, 2 and 4: 2 warm-up and 5 timed steps each;
              edges/s, ms a step, host ms a batch (remote sample_node,
              remote sample_fanout, lookup), busy share, RPC transport
              counters and health; a finite falling loss, no skipped
              step or degraded batch, no gather_mean launch; the
              engines, shards and registry stopped and released
 9m. mesh     multi-device training as a world of one: an NCCL process
              group of one rank on the card, make_mesh() ({data: 1,
              model: 1}); the flagship through NodeEstimator(mesh=...)
              at K = 32, 2 windows (the first eager, then a captured
              graph with the data-axis gradient all-reduce in it),
              against the same estimator without a mesh on the same
              batches: losses, parameters, buffers and Adam's state
              bit for bit; the collectives a step and gather_mean's
              launches a window; one replay event-timed with and
              without the mesh (NCCL's cost a step in a world of one);
              then ShardedSupervisedGraphSage (id_dim 16, an id table of
              2,450,000 rows, dim 128) at the flagship's fanouts and
              batch, its [15, 10] rows drawn by the flagship's sampler
              and their features gathered from the int8 table on the
              card, 8 steps at K = 4 (a finite, falling loss), and the
              same model at dim 16 on 64 roots under Adam, 9 steps at
              K = 4: float32 with the mesh against the card without
              one bit for bit, step 1's float32 gradients of the card
              and the CPU against float64 leaf by leaf, and float64
              with the mesh on the card against the CPU without one
              (losses and parameters within 1e-9); the meshed
              flagship's state as the estimator writes it:
              (i) the checkpoint its train() wrote under
              build/chip_smoke_mesh (checkpoint_steps 64) against the
              unmeshed one's, bit for bit, and restored into a fresh
              meshed estimator bit for bit; (ii) export_bundle over 8
              batches of infer_input_fn against the unmeshed bundle
              (parameters, ids, embeddings bit for bit; gather_mean
              once a forward); (iii) ShardedSupervisedGraphSage's
              checkpoint (the 2,450,000-row id table and its Adam
              moments) restored bit for bit; (iv) the activation-cache
              estimator, 2 steps, shard_act_cache and refresh_act_cache
              with the mesh against without, bit for bit, gather_mean's
              launches a refresh; (v) LINE (split) and TransE
              (replicated) as their runners build them, 3 steps with
              the mesh against without, bit for bit; memory_plan's
              per-card bytes for the flagship's
              tables at 1 and 4 cards (arithmetic, not measured); the
              process group destroyed and the files removed
 10. quality  (in six worker processes started after phase 2 and joined
              after phase 9k (a), (c), before any timed phase: their
              runs are bound by the host and overlap the graph set-up;
              the layerwise and conv runners share one process and one
              cora engine) the port's GraphSAGE runner (fit_citation,
              --int8_features)
              on the cora stand-in for seeds 0, 1, 2: mean test
              micro-F1 at least 0.79 (the RESULTS.md row is 0.811); the
              unsupervised runners: DeepWalk and LINE on cora against
              their RESULTS.md rows (floor 0.95), unsupervised GraphSAGE
              on ppi for seeds 0, 1, 2 against the JAX package's own
              10-seed mean within 2 standard errors (floor 0.5);
              run_geniepath and run_graphsage --act_cache on cora for
              seeds 0, 1, 2 against RESULTS.md's geniepath-dev 0.771
              and graphsage-dev-cache 0.805 (floor 0.70), each failing
              unless it lies within 0.01 of its row or within 2
              standard errors of the JAX package's own 10-seed mean;
              the host-fed runners (no --device_sampler) for seeds
              0-2: run_graphsage cora (row 0.805), run_deepwalk and
              run_line cora (0.996, 0.991), run_graphsage --mode
              unsupervised ppi (0.551), each failing unless within 0.01
              of its row or 2 standard errors of the JAX package's own
              10-seed mean (tests/oracle_hostfed.py); run_fastgcn (host
              flow and --device_sampler) and the nine conv runners
              (gcn, gat, appnp, agnn, arma, sgcn, tagcn, adaptivegcn,
              dna) on cora for seeds 0-2 in one process over one cora
              engine, each failing unless within 0.01 of its RESULTS.md
              row or 2 standard errors of the JAX package's own 10-seed
              mean (tests/oracle_mp.py); in the third process slice 10's
              runners for seeds 0-2: run_gin, run_graphgcn,
              run_gated_graph and run_set2set on mutag (rows 0.921,
              0.895, 0.947, 0.921), run_lgcn (0.763), run_gae (0.881,
              the eval AUC) and run_dgi (0.672, the probe) on cora, each
              failing unless within 0.01 of its row or 2 standard errors
              of the JAX package's own 10-seed mean
              (tests/oracle_graph.py); slice 11's runners for seeds
              0-2: in the fourth process run_geniepath host-fed on cora
              (row 0.763); in the sixth run_scalable_sage host-fed
              (0.731, seeds 0-9) and run_solution (0.774) on cora, then
              run_sample_solution once against its floor, after
              run_transx --model TransE/TransH/TransR/TransD and
              run_distmult (0.914, 0.915, 0.860, 0.880, 0.901) and
              run_rgcn (0.730) on the fb15k237 stand-in (RESULTS.md
              names those rows "fb15k"; the runners' default dataset is
              fb15k237), each failing unless within 0.01 of its row or
              2 standard errors of the JAX package's own 10-seed mean
              (tests/oracle_hostfed.py, tests/oracle_kg.py) and
              run_deepwalk on ml_1m; in the fifth process run_line; both
              host-fed on the synthetic ml_1m graph for seeds 0-2 (rows
              0.636, 0.680; LINE's 125,026 steps at steps_per_loop 32,
              one CUDA graph replay per 32 host-fed steps), each failing
              unless within 0.01 of its row or 2 standard errors of the
              JAX package's own 10-seed mean (tests/oracle_data.py);
              each gate printed, met or not
 11. small    a small input through the card and through the CPU path
 12. serve    the training tables freed (the neighbor table stays for
              9k (b)), then through the TCP stack on
              the card: InferenceServer loads v1 (verified) and uploads
              its table; embed exact, score within its float32 bound,
              16 exact knn (8 ids, k 10) byte-identical to brute_force;
              latency legs (8 threads x 200 requests x 8 ids) batch-1
              vs micro-batched (64, 2 ms) for embed and score: p50,
              p99, p999, req/s, shed, lost (0); a swap to v2 under
              embed traffic (0 lost, answers after the flip v2's, the
              swap's time and its worst request); save_sharded(2) of v1
              and two shard replicas on the card behind a dir:
              registry, whose scatter-gather knn is byte-identical to
              brute_force over the unsharded table. Bundles are written
              under build/chip_smoke_bundles and removed at the end
 13. result   the kernels JSON line, then {"ok": true, "device": ...}

Without CUDA it exits 1 and prints no result. --out PATH also writes
the full record (every case, timing and profile) as JSON.
--extra-loop-k K also times phase 7's loop at steps_per_loop = K.
--baseline-source PATH builds an earlier gather_mean.cu that has the
first kernel's C entry (gather_mean_launch without plan arguments) and
times it against the current kernel in phase 4, in turns (old, new,
new, old) on every case.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import io
import json
import multiprocessing
import os
import re
import shutil
import socket
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from euler_tpu_torch import obs
from euler_tpu_torch.convert import (
    gather_optimizer_state_dict, gather_state_dict,
)
from euler_tpu_torch.core import lib as engine_lib
from euler_tpu_torch.dataflow import FanoutDataFlow
from euler_tpu_torch.dataset import engine_from_arrays, get_dataset
from euler_tpu_torch.dataset.synthetic import products_like, synthetic_citation
from euler_tpu_torch.estimator import base_estimator
from euler_tpu_torch.estimator.base_estimator import BaseEstimator
from euler_tpu_torch.estimator.estimators import NodeEstimator
from euler_tpu_torch.estimator.infer import NodeInferencer
from euler_tpu_torch.estimator.prefetch import make_feeder
from euler_tpu_torch.estimator.streaming import StreamingDriver
from euler_tpu_torch.examples import (
    common, graph_common, run_adaptivegcn, run_agnn, run_appnp, run_arma,
    run_deepwalk, run_dgi, run_distmult, run_dna, run_fastgcn, run_gae,
    run_gat, run_gated_graph, run_gcn, run_geniepath, run_gin,
    run_graphgcn, run_graphsage, run_lgcn, run_line, run_rgcn,
    run_sample_solution, run_scalable_sage, run_set2set, run_sgcn,
    run_solution, run_tagcn, run_transx,
)
from euler_tpu_torch.examples.common import (
    ConvModel, full_batch_flow, root_input_fn,
)
from euler_tpu_torch.kernels import _build
from euler_tpu_torch.models.embedding_models import (
    LINE, DeviceSampledSkipGram,
)
from euler_tpu_torch.models.kg_models import TransE
from euler_tpu_torch.models.graphsage import (
    DeviceSampledGraphSage, DeviceSampledLayerwiseGCN,
    DeviceSampledScalableSage, DeviceSampledUnsupervisedSage,
    ShardedSupervisedGraphSage, SupervisedGraphSage, refresh_act_cache,
    shard_act_cache,
)
from euler_tpu_torch.ops import gather_mean as gather_mean_module
from euler_tpu_torch.ops.gather_mean import (
    gather_mean, gather_mean_reference, launch_plan, take_rows,
)
from euler_tpu_torch.parallel.device_layerwise import dense_adjacency
from euler_tpu_torch.parallel.device_sampler import (
    DeviceNeighborTable, _fill_table_rows, build_alias_tables,
    fuse_tables_host, sample_hop, slot_weights,
)
from euler_tpu_torch.parallel.device_walk import (
    DeviceNodeSampler, gen_pair_offsets,
)
from euler_tpu_torch.parallel.feature_store import (
    DeviceFeatureStore, dequantize_rows,
)
from euler_tpu_torch.parallel import collectives
from euler_tpu_torch.parallel.memory_plan import (
    plan_partitioned_table, plan_tables,
)
from euler_tpu_torch.parallel.mesh import make_mesh
from euler_tpu_torch.parallel.multihost import (
    MultihostConfig, finalize_multihost, free_port, initialize_multihost,
)
from euler_tpu_torch.mp_utils.base import ModelOutput, SuperviseModel
from euler_tpu_torch.mp_utils.group_gnn import GroupGNNNet
from euler_tpu_torch.estimator.retry import RetryPolicy
from euler_tpu_torch import gql
from euler_tpu_torch.graph import (
    CachedGraphEngine, GraphBuilder, RemoteGraphEngine, delta_dirty_ids,
    rpc_transport_stats,
)
from euler_tpu_torch.graph import seed as seed_engine
from euler_tpu_torch.serving import wire
from euler_tpu_torch.serving import InferenceServer, ModelBundle, ServingClient
from euler_tpu_torch.tools.knn import brute_force
from euler_tpu_torch.utils.layers import PReLU

FULL_NODES = 2_450_000
AVG_DEGREE, FEAT_DIM, NUM_CLASSES, CAP = 50, 100, 16, 32
DIM, FANOUTS, BATCH = 128, (15, 10), 32768
# H100 SXM published peaks (NVIDIA data sheet), for the bound
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
TIMED_SAMPLES, BURST = 20, 5
# training (bench.py:776-911): Adam at lr 0.01, 5 warm-up steps, 30
# timed steps in 3 windows; then event-timed steps
TRAIN_LR, WARMUP_STEPS, TIMED_STEPS, WINDOWS, EVENT_STEPS = 0.01, 5, 30, 3, 10
EDGES_PER_STEP = sum(BATCH * int(np.prod(FANOUTS[:h + 1]))
                     for h in range(len(FANOUTS)))
# the K-step loop (bench.py:41-44, :622-657, :857-899): K = 32, the
# prefetch thread's depth 3, K + 2 warm-up steps, 3 timed windows
LOOP_K, FEEDER_DEPTH, LOOP_WINDOW_STEPS, LOOP_EQ_WINDOWS = 32, 3, 64, 3
# quality: RESULTS.md graphsage-dev-int8 | cora | micro-F1 | 0.811
QUALITY_SEEDS, QUALITY_FLOOR, QUALITY_ROW, QUALITY_BAND = (0, 1, 2), 0.79, \
    0.811, 0.01
# the unsupervised family: full-width GraphSAGE with 5 negatives (graph
# vs eager at K = 8); DeepWalk at bench.py --walk's shape (bench.py:
# 403-404, 814-818: walk_len 5, window 1/1, 5 negatives, K = 8)
UNSUP_NEGS, UNSUP_EQ_K = 5, 8
WALK_LEN, WALK_NEGS, WALK_K = 5, 5, 8
# quality: RESULTS.md deepwalk-dev | cora | mrr | 0.995 and line-dev |
# cora | mrr | 0.986; unsupervised GraphSAGE on ppi has no row: the JAX
# package's own --device_sampler runner, mean eval MRR over engine seeds
# 0-9 on the CPU (tests/oracle_unsup_ppi.py --seeds 0 ... 9: 0.5834,
# standard deviation over seeds 0.0114), against the port's runner with
# --device cpu --seed 0-9 (standard deviation 0.0168). The gate: the
# card's mean over QUALITY_SEEDS within 2 standard errors of the
# difference, sqrt(sd_port^2 / 3 + sd_ref^2 / 10). The floors catch
# broken training; the gates are printed, met or not.
DEEPWALK_ROW, LINE_ROW, UNSUP_FLOOR = 0.995, 0.986, 0.95
PPI_ORACLE, PPI_REF_SD, PPI_PORT_SD, PPI_FLOOR = 0.5834, 0.0114, 0.0168, 0.5
# serving (tools/bench_serve.py:194-208, serve_smoke's shape): 8 client
# threads, 8 ids a request, batch-1 (max_batch 1, flush_ms 0) against
# micro-batched (64, 2 ms), nothing injected; 200 requests a thread so
# that p99 is resolved; 16 exact knn requests (k 10); embed/score checks
# of 64 ids; the swap drill runs until 400 answers were sent after the
# flip
SERVE_THREADS, SERVE_IDS, SERVE_REQS, SERVE_K = 8, 8, 200, 10
SERVE_LEGS = ((1, 0.0), (64, 2.0))
SERVE_KNN_REQS, SERVE_CHECK_REQS, SERVE_AFTER_SWAP = 16, 16, 400
SERVE_JOIN_S = 300.0
# the alias and fused layouts (bench.py --alias_sampler / --fused_sampler,
# bench.py:264-280): at least 10^7 alias draws on a seeded weighted table
# against the cum weights (chi-squared, p = 0.001), the flagship at K = 32
ALIAS_DRAWS, ALIAS_ROWS, CHI2_Z = 10_000_000, 64, 3.090
# the activation cache (bench.py --act_cache, bench.py:840-849, :898-904):
# DeviceSampledScalableSage dim 128, one hop of fanouts[0] = 15, 2 layers,
# a bfloat16 cache; edges per step 2 * B * 15; refresh_act_cache over all
# rows in 8192-row chunks
CACHE_FANOUT, CACHE_LAYERS, CACHE_CHUNK = 15, 2, 8192
CACHE_EDGES_PER_STEP = CACHE_LAYERS * BATCH * CACHE_FANOUT
# quality: RESULTS.md geniepath-dev | cora | 0.771 and graphsage-dev-cache
# | cora | 0.805 (run_geniepath, run_graphsage --act_cache). Neither the
# reference's own runner nor the port's reaches its row today, so each is
# also held to the JAX package's own 10-seed mean on the CPU with its
# init moved by the seed as the port's --seed moves it
# (tests/oracle_citation.py --vary_init --seeds 0 ... 9: mean, sd),
# within 2 standard errors of the difference, sqrt(sd_port^2 / 3 +
# sd_ref^2 / 10), sd_port over the port's runner with --device cpu
# --seed 0-9. Both are printed, met or not; the run fails when neither
# is met, or below the floor.
# the host-fed path (bench.py --host_sampler, bench.py:821-869):
# FanoutDataFlow(graph, [15, 10], with_features=False) rows into the int8
# table, SupervisedGraphSage dim 128, batch 32768, Adam lr 0.01, K = 1;
# 2 warm-up steps and 5 timed steps (each batch is sampled on the host)
HOST_WARMUP, HOST_TIMED = 2, 5
# phase 9l: the graph service. The flagship's engine dumped as 2
# partitions, served by 2 shards found through a tcp: registry; the
# pooled remote client (GRAPH_POOL workers over pooled query handles,
# chunks of 4,096 ids) under a client cache; reads checked on
# REMOTE_CHECK_IDS seeded ids; the host-fed step trained from the cluster
# with feeder_workers 0 and each of GRAPH_FEEDERS (HOST_WARMUP +
# HOST_TIMED steps each)
GRAPH_POOL, GRAPH_FEEDERS, REMOTE_CHECK_IDS = 8, (2, 4), 4096
# host-fed quality: the port's runners without --device_sampler for
# QUALITY_SEEDS against their RESULTS.md rows (graphsage | cora 0.805,
# deepwalk | cora 0.996, line | cora 0.991, graphsage-unsup | ppi 0.551);
# each fails the run unless its mean is within 0.01 of its row or within
# 2 standard errors of the difference, sqrt(sd_port^2 / 3 + sd_ref^2 /
# 10), from the JAX package's own 10-seed mean (tests/oracle_hostfed.py
# --seeds 0 ... 9 on the CPU: mean, sd) with sd_port over the port's
# runner with --device cpu --seed 0-9 (the same script, --port).
# name → (runner, argv, result key, row, floor, ref mean, ref sd, port sd)
HOSTFED_QUALITY = {
    "graphsage cora": ("run_graphsage", [], "test_metric", 0.805, 0.77,
                       0.8176, 0.0055, 0.0116),
    "deepwalk cora": ("run_deepwalk", [], "eval_metric", 0.996, 0.95,
                      0.9959, 0.0004, 0.0005),
    "line cora": ("run_line", [], "eval_metric", 0.991, 0.95,
                  0.9900, 0.0011, 0.0012),
    "graphsage-unsup ppi": ("run_graphsage", ["--mode", "unsupervised",
                                              "--dataset", "ppi"],
                            "eval_metric", 0.551, 0.5, 0.5592, 0.0129,
                            0.0151),
}
GENIE_ROW, CACHE_ROW, SLICE7_FLOOR = 0.771, 0.805, 0.70
GENIE_ORACLE, GENIE_REF_SD, GENIE_PORT_SD = 0.7430, 0.0251, 0.0277
CACHE_ORACLE, CACHE_REF_SD, CACHE_PORT_SD = 0.7922, 0.0068, 0.0094
# the layerwise family (bench.py --layerwise, bench.py:513-585) on the
# phase-3 tables: DeviceSampledLayerwiseGCN dim 128, batch 512, pools
# (512, 512), Adam lr 0.01, fed by the prefetch thread; K = 1 as phase 6,
# K = 32 with 2 timed windows of 64 steps; bench.py's metric counts
# batch + sum(pools) nodes a step
LW_BATCH, LW_SIZES, LW_WINDOWS = 512, (512, 512), 2
LW_NODES_PER_STEP = LW_BATCH + sum(LW_SIZES)
# full-batch message passing on the pubmed stand-in (19,717 nodes, 500
# features): the runners' GCN (run_gcn: dim 32, Adam lr 0.01) and GAT
# (run_gat: dim 16, 8 heads, input dropout 0.6, lr 0.005, weight decay
# 0.005) models, batch 128; 20 timed steps each
MP_DATASET, MP_BATCH, MP_WARMUP, MP_TIMED = "pubmed", 128, 3, 20
MP_MODELS = {"gcn": dict(dim=32, dropout=0.0, lr=0.01, wd=0.0, kw={}),
             "gat": dict(dim=16, dropout=0.6, lr=0.005, wd=0.005,
                         kw={"heads": 8})}
# quality of the layerwise and message-passing runners on cora, seeds
# 0-2 on the card, their defaults: each fails the run unless its mean is
# within 0.01 of its RESULTS.md row or within 2 standard errors of the
# difference, sqrt(sd_port^2 / 3 + sd_ref^2 / 10), from the JAX
# package's own 10-seed mean (tests/oracle_mp.py --seeds 0 ... 9 on the
# CPU: mean, sd), sd_port over the port's runner with --device cpu
# --seed 0-9 (the same script, --port); below MP_FLOOR it fails too.
# name → (runner, argv, row, ref mean, ref sd, port sd)
MP_FLOOR = 0.70
MP_QUALITY = {
    "fastgcn cora": ("run_fastgcn", [], 0.816, 0.8345, 0.0132, 0.0120),
    "fastgcn-dev cora": ("run_fastgcn", ["--device_sampler"], 0.827,
                         0.8401, 0.0137, 0.0132),
    "gcn cora": ("run_gcn", [], 0.846, 0.8463, 0.0107, 0.0202),
    "gat cora": ("run_gat", [], 0.820, 0.8314, 0.0133, 0.0106),
    "appnp cora": ("run_appnp", [], 0.897, 0.8641, 0.0088, 0.0158),
    "agnn cora": ("run_agnn", [], 0.880, 0.8811, 0.0076, 0.0097),
    "arma cora": ("run_arma", [], 0.857, 0.8568, 0.0109, 0.0070),
    "sgcn cora": ("run_sgcn", [], 0.895, 0.8837, 0.0055, 0.0063),
    "tagcn cora": ("run_tagcn", [], 0.864, 0.8561, 0.0147, 0.0241),
    "adaptivegcn cora": ("run_adaptivegcn", [], 0.817, 0.8135, 0.0052,
                         0.0121),
    "dna cora": ("run_dna", [], 0.809, 0.8205, 0.0212, 0.0202),
}
# slice 10, graph classification and the zoo at the runners' default
# widths: the four mutag runners' GraphModels (name → conv, pool, the
# runner's own defaults), GAE and VGAE (a fixed ε) and LGCN on cora, DGI
# (dim 512) on cora's whole graph; ZOO_WARMUP steps, then ZOO_TIMED
# timed steps each
ZOO_WARMUP, ZOO_TIMED, ZOO_REPEAT_STEPS = 3, 20, 3
GRAPH_MODELS = {
    "gin": ("gin", "sum", {}),
    "graphgcn": ("gcn", "sum", dict(num_layers=4, hidden_dim=64,
                                    max_steps=1200)),
    "gated_graph": ("gated", "attention", {}),
    "set2set": ("gin", "set2set", {}),
}
# quality of slice 10's runners, seeds 0-2 on the card at their
# defaults: each fails the run unless its mean is within 0.01 of its
# RESULTS.md row or within 2 standard errors of the difference,
# sqrt(sd_port^2 / 3 + sd_ref^2 / 10), from the JAX package's own
# 10-seed mean (tests/oracle_graph.py --seeds 0 ... 9 on the CPU: mean,
# sd), sd_port over the port's runner with --device cpu --seed 0-9 (the
# same script, --port); below GRAPH_FLOOR it fails too. The mutag
# metric is the eval sweep's accuracy (38 graphs), gae's the eval AUC
# (RESULTS.md labels the row "mrr"), dgi's the ridge probe's accuracy.
# name → (runner, argv, result key, row, ref mean, ref sd, port sd)
GRAPH_FLOOR = 0.6
GRAPH_QUALITY = {
    "gin mutag": ("run_gin", [], "eval_metric", 0.921, 0.9053, 0.0136,
                  0.0139),
    "graphgcn mutag": ("run_graphgcn", [], "eval_metric", 0.895, 0.8737,
                       0.0166, 0.0208),
    "gated_graph mutag": ("run_gated_graph", [], "eval_metric", 0.947,
                          0.9289, 0.0127, 0.0136),
    "set2set mutag": ("run_set2set", [], "eval_metric", 0.921, 0.9211,
                      0.0, 0.0124),
    "lgcn cora": ("run_lgcn", [], "test_metric", 0.763, 0.7452, 0.0250,
                  0.0308),
    "gae cora": ("run_gae", [], "eval_metric", 0.881, 0.8784, 0.0126,
                 0.0182),
    "dgi cora": ("run_dgi", [], "eval_metric", 0.672, 0.6917, 0.0361,
                 0.0327),
}

# slice 11 (phase 9j): cora's whole graph gets S11_RELATIONS synthetic
# relations for RelationConv and GroupGNNNet (an edge's source row mod
# S11_RELATIONS; GroupGNNNet's two groups by its parity)
S11_RELATIONS = 4
S11_KG_MODELS = ("TransE", "TransH", "TransR", "TransD", "DistMult")
# quality of slice 11's runners (SLICE11_QUALITY on cora, KG_QUALITY
# on the fb15k237 stand-in), seeds 0-2 on the card at their defaults,
# gated as GRAPH_QUALITY is: the JAX package's 10-seed means
# and sds from tests/oracle_hostfed.py (geniepath, scalable_sage,
# solution) and tests/oracle_kg.py (the rest), the port's sds from the
# same scripts with --port. The KG runners run on their default dataset,
# the fb15k237 stand-in (RESULTS.md names the rows "fb15k"); their
# metric is the eval MRR, the cora runners' the test micro-F1.
# name → (runner, argv, result key, row, ref mean, ref sd, port sd[,
# seeds]). The host-fed scalable_sage runs seeds 0-9 on the card (3 s a
# run): on an H100 host (torch 2.11) its test micro-F1 spreads with an
# sd of 0.0276 over seeds 0-9, against 0.0144 for the same seeds on the
# CPU where the oracles ran (torch 2.13); that host's card and CPU give
# the same result for a seed (0.6586 at seed 0), and seeds 0-2 alone
# (0.6586, 0.6770, 0.6828) sit 2.5 of its sds below its 10-seed mean
# (0.7027; PERF.md). The 10-seed mean is held to the same rule, with
# its standard error over 10 seeds.
SCALABLE_SEEDS = tuple(range(10))
S11_FLOOR = 0.6
SLICE11_QUALITY = {
    "geniepath cora (host-fed)": ("run_geniepath", [], "test_metric",
                                  0.763, 0.7515, 0.0334, 0.0233),
    "scalable_sage cora (host-fed)": ("run_scalable_sage", [],
                                      "test_metric", 0.731, 0.7129, 0.0189,
                                      0.0144, SCALABLE_SEEDS),
    "solution cora": ("run_solution", [], "test_metric", 0.774, 0.7998,
                      0.0217, 0.0172),
}
KG_QUALITY = {
    "transe fb15k237": ("run_transx", ["--model", "TransE"], "eval_metric",
                        0.914, 0.9083, 0.0038, 0.0034),
    "transh fb15k237": ("run_transx", ["--model", "TransH"], "eval_metric",
                        0.915, 0.9074, 0.0039, 0.0041),
    "transr fb15k237": ("run_transx", ["--model", "TransR"], "eval_metric",
                        0.860, 0.8478, 0.0036, 0.0039),
    "transd fb15k237": ("run_transx", ["--model", "TransD"], "eval_metric",
                        0.880, 0.8806, 0.0048, 0.0044),
    "distmult fb15k237": ("run_distmult", [], "eval_metric", 0.901, 0.8959,
                          0.0041, 0.0040),
    "rgcn fb15k237": ("run_rgcn", [], "eval_metric", 0.730, 0.7169, 0.0093,
                      0.0093),
}
# run_sample_solution has no RESULTS.md row: one run (seed 0) must reach
# this eval micro-F1. Its evaluation reads the training file's batches;
# the reference's runner and the port's each gave 1.0 in one CPU run.
SAMPLE_SOLUTION_FLOOR = 0.95
# phase 9k, graphs that change, on the flagship's graph and table: an
# edge-only delta of STREAM_EDGES directed edges between existing nodes
# (weight 1, as the flagship's), then growth by STREAM_GROW nodes with
# STREAM_GROW_DEG edges each to existing nodes plus their reverses,
# drawn from STREAM_SEED
STREAM_EDGES, STREAM_GROW, STREAM_GROW_DEG, STREAM_SEED = 65_536, 4_096, \
    8, 12
# quality of DeepWalk and LINE on the synthetic MovieLens-1M graph
# (dataset/ml_1m.py: 6,040 users, 3,706 items, 2,000,418 directed rated
# edges), host-fed at the runners' defaults and auto step rules (DeepWalk
# 1,522 steps; LINE 125,026 steps, run at steps_per_loop 32: the same
# steps as K = 1, one CUDA graph replay per 32), seeds 0-2 on the card,
# gated as GRAPH_QUALITY is against RESULTS.md's deepwalk | ml_1m 0.636
# and line | ml_1m 0.680 and the JAX package's 10-seed CPU means
# (tests/oracle_data.py: mean, sd; the port's sds from the same script
# with --port). name → (runner, argv, result key, row, ref mean, ref sd,
# port sd)
DATA_FLOOR = 0.5
DATA_QUALITY = {
    "deepwalk ml_1m": ("run_deepwalk", ["--dataset", "ml_1m"], "eval_metric",
                       0.636, 0.6366, 0.0037, 0.0036),
    "line ml_1m": ("run_line", ["--dataset", "ml_1m", "--steps_per_loop",
                                "32"], "eval_metric", 0.680, 0.6772, 0.0087,
                   0.0073),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def query_card() -> str:
    """`name, power.limit` as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn) -> float:
    """Median over TIMED_SAMPLES of CUDA-event time per call, each sample
    a burst of BURST back-to-back calls (so host overhead overlaps the
    device work), after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(TIMED_SAMPLES):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(BURST):
            fn()
        stop.record()
        stop.synchronize()
        samples.append(start.elapsed_time(stop) / BURST)
    return statistics.median(samples)


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def gather_mean_bound(table, rows, scale, out_dtype) -> dict:
    """Least time for the work: each distinct table row this run reads,
    the indices and the scale read once, the output written once; the
    adds and multiplies at the float32 rate."""
    n, k = rows.shape
    d = table.shape[1]
    distinct = int(torch.unique(rows).numel())
    nbytes = (rows.numel() * rows.element_size()
              + distinct * d * table.element_size()
              + (scale.numel() * scale.element_size() if scale is not None
                 else 0)
              + n * d * torch.tensor([], dtype=out_dtype).element_size())
    ops = n * k * d + 2 * n * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "operations": ops, "distinct_rows": distinct}


def phase_device() -> dict:
    card = query_card()
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("device: torch %s cuda %s numpy %s, %s x%d; matmul.allow_tf32=%s "
        "cudnn.allow_tf32=%s" % (
            torch.__version__, torch.version.cuda, np.__version__,
            torch.cuda.get_device_name(0), torch.cuda.device_count(),
            torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32))
    return {"nvidia_smi": card, "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "torch": torch.__version__,
            "cuda": torch.version.cuda, "numpy": np.__version__}


def ptxas_report(nvcc_log: str) -> list:
    """[(kernel, registers, spill bytes)] from nvcc's -Xptxas -v output,
    kernel names demangled where c++filt exists."""
    rows, name, spill = [], None, 0
    for line in nvcc_log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name, spill = m.group(1), 0
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = int(m.group(1)) + int(m.group(2))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            rows.append([name, int(m.group(1)), spill])
            name = None
    if rows and shutil.which("c++filt"):
        out = subprocess.run(["c++filt"], input="\n".join(r[0] for r in rows),
                             capture_output=True, text=True, timeout=60)
        names = out.stdout.splitlines()
        if len(names) == len(rows):
            for r, n in zip(rows, names):
                n = n.replace("(anonymous namespace)::", "")
                r[0] = re.sub(r"^void |\(.*", "", n)
    return [tuple(r) for r in rows]


def start_baseline_build(src: str) -> tuple:
    """nvcc for an earlier gather_mean.cu, started now (it runs beside
    the current kernel's build); wait with finish_baseline_build."""
    out = _build.BUILD_DIR / "baseline" / "gather_mean.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.Popen(
        [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(out), src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, out


def finish_baseline_build(proc, out):
    import ctypes

    log_text, _ = proc.communicate(timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"baseline gather_mean build failed:\n{log_text}")
    fn = ctypes.CDLL(str(out)).gather_mean_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def baseline_gather_mean(fn, table, rows, scale, out=None):
    """The earlier kernel on the same inputs (its dtype codes are the
    current ones), into `out` when given; not counted in
    gather_mean.launches."""
    codes = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
    n, k = rows.shape
    if out is None:
        out = torch.empty(
            (n, table.shape[1]),
            dtype=scale.dtype if scale is not None else table.dtype,
            device=table.device)
    rc = fn(table.data_ptr(), codes[table.dtype], rows.data_ptr(),
            scale.data_ptr() if scale is not None else None,
            codes[scale.dtype] if scale is not None else -1, out.data_ptr(),
            n, k, table.shape[1], table.shape[0],
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"baseline gather_mean launch failed: {rc}")
    return out


def phase_build(baseline_source=None) -> tuple:
    base = (start_baseline_build(baseline_source) if baseline_source
            else None)
    # the engine's g++ jobs (one a source) run beside nvcc
    engine = engine_lib.start_build()
    r = _build.build("gather_mean")
    log(f"build: gather_mean {r['seconds']:.1f}s")
    e = engine.wait()
    log(f"build: graph engine ({e['sources']} sources, g++ "
        f"{' '.join(engine_lib.CXXFLAGS + engine_lib.LDFLAGS)}) "
        f"{e['seconds']:.1f}s, "
        f"{engine_lib.library_path()}")
    report = ptxas_report(r["log"])
    for name, regs, spill in report:
        log(f"  ptxas {name}: {regs} registers, {spill} bytes spilled")
    spilled = [x for x in report if x[2] > 0]
    if not report:
        raise AssertionError("no ptxas report for gather_mean (remove its "
                             "library under build/ to rebuild it)")
    if spilled:
        raise AssertionError(f"ptxas spilled registers: {spilled}")
    t0 = time.monotonic()
    base_fn = finish_baseline_build(*base) if base else None
    if base:
        log(f"build: baseline gather_mean ({baseline_source}) ready "
            f"{time.monotonic() - t0:.1f}s after the current one")
    return {"gather_mean_seconds": r["seconds"], "ptxas": report,
            "engine_seconds": e["seconds"],
            "engine_sources": e["sources"]}, base_fn


def phase_graph(dev: torch.device):
    """The flagship's graph as bench.py's rebuild path builds it
    (bench.py:96-108, :334-366): the products-like arrays into the
    graph engine, then the neighbor table and the int8 feature store
    (bfloat16 scale) read from the engine. The host tables stay for
    phase 9a's fused and alias layouts and phase 9k's patches."""
    t0 = time.monotonic()
    g = products_like(FULL_NODES, AVG_DEGREE, FEAT_DIM, NUM_CLASSES)
    t_arrays = time.monotonic() - t0
    t0 = time.monotonic()
    graph = engine_from_arrays(g, name="bench").engine
    t_engine = time.monotonic() - t0
    del g
    t0 = time.monotonic()
    table = DeviceNeighborTable(graph, cap=CAP, keep_host=True, device=dev)
    t_table = time.monotonic() - t0
    t0 = time.monotonic()
    store = DeviceFeatureStore(graph, ["feature"], label_fid="label",
                               label_dim=NUM_CLASSES, dtype=torch.bfloat16,
                               quantize="int8", device=dev)
    t_store = time.monotonic() - t0
    nodes, edges = graph.node_count, graph.edge_count
    if nodes != FULL_NODES:
        raise AssertionError(f"engine holds {nodes} nodes, not {FULL_NODES}")
    log(f"graph: arrays in {t_arrays:.1f}s; engine {nodes} nodes, {edges} "
        f"directed edges, built in {t_engine:.1f}s; neighbor table from "
        f"the engine in {t_table:.1f}s (uniform_rows={table.uniform_rows}, "
        f"hub_frac={table.hub_frac:.3f}, edge_keep_frac="
        f"{table.edge_keep_frac:.3f}); feature store in {t_store:.1f}s")
    return store, table, graph, {
        "nodes": nodes, "directed_edges": edges,
        "arrays_seconds": t_arrays, "engine_seconds": t_engine,
        "table_seconds": t_table, "store_seconds": t_store,
        "uniform_rows": table.uniform_rows, "hub_frac": table.hub_frac,
        "edge_keep_frac": table.edge_keep_frac}


def cora_case(dev: torch.device) -> tuple:
    """The cora runner's gather_mean shapes (run_graphsage.py defaults:
    batch 64, fanouts [10, 10], so n = 640 hop-1 rows with k = 10 over a
    [2709, 1433] int8 table with a float32 scale), seeded data."""
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.integers(-127, 128, (2709, 1433),
                                      dtype=np.int8)).to(dev)
    scale = torch.from_numpy(rng.random(1433, dtype=np.float32)
                             / 127).to(dev)
    rows = torch.from_numpy(rng.integers(0, 2708, (640, 10),
                                         dtype=np.int32)).to(dev)
    return q, scale, rows


def payload_bytes(table, rows, out_dtype) -> int:
    """What the kernel moves as it gathers: every (row, neighbor) row
    read whole, the indices, the output (the bound counts distinct rows
    instead)."""
    n, k = rows.shape
    d = table.shape[1]
    return (n * k * d * table.element_size() + rows.numel() * 4
            + n * d * torch.tensor([], dtype=out_dtype).element_size())


def phase_kernels(store, rows: torch.Tensor, dev: torch.device,
                  baseline=None, cache_rows=None) -> dict:
    """gather_mean vs its plain version on the path's own deepest-hop
    rows [n, k] and feature table, the cora runner's shapes, the path's
    table one byte off alignment, and the activation cache's two reads
    (cache_rows [B, 15]: layer 0 over the int8 feature table, layer 1
    over a seeded bfloat16 cache [N+1, 128] with a float32 output), and
    the host-fed ScalableGraphSage's cache read (a seeded float32 cache
    [2708, 32], rows [64, 10]).
    Tolerances: float32 outputs within 1e-5 of the largest value
    (summation order and the 1/k and scale multiplies); bfloat16 outputs
    within 2^-7 of the largest (one bf16 rounding). With a baseline
    kernel, old and new are timed in turns (old, new, new, old) on every
    case it takes."""
    q, scale_bf16 = store.features, store.feature_scale
    scale_f32 = scale_bf16.float()
    table_f32 = q.float() * scale_f32
    shifted = torch.empty(q.numel() + 1, dtype=torch.int8, device=dev)
    shifted[1:] = q.view(-1)
    shifted = shifted[1:].view(q.shape)
    cq, cscale, crows = cora_case(dev)
    cases = [
        ("int8+bf16 scale", q, scale_bf16, rows,
         lambda: q.to(torch.bfloat16) * scale_bf16, None),
        ("int8+f32 scale", q, scale_f32, rows, lambda: table_f32, None),
        ("f32 table", table_f32, None, rows, lambda: table_f32, None),
        ("cora int8+f32 scale", cq, cscale, crows,
         lambda: cq.float() * cscale, None),
        ("int8+bf16 scale, table 1 byte off", shifted, scale_bf16, rows,
         lambda: q.to(torch.bfloat16) * scale_bf16, None),
    ]
    if cache_rows is not None:
        gen = torch.Generator(device=dev).manual_seed(3)
        cache = torch.randn((q.shape[0], DIM), generator=gen, device=dev,
                            dtype=torch.float32).to(torch.bfloat16)
        cases += [
            ("act cache layer 0: int8+bf16 scale", q, scale_bf16, cache_rows,
             lambda: q.to(torch.bfloat16) * scale_bf16, None),
            ("act cache layer 1: bf16 cache -> f32", cache, None, cache_rows,
             lambda: cache.float(), torch.float32)]
    # the host-fed ScalableGraphSage's layer-1 read (run_scalable_sage's
    # defaults on cora): a float32 cache [max_id + 1, 32], 64 roots x 10
    gen = torch.Generator(device=dev).manual_seed(5)
    f32_cache = torch.randn((2708, 32), generator=gen, device=dev)
    f32_rows = torch.randint(0, 2708, (64, 10), generator=gen, device=dev,
                             dtype=torch.int32)
    cases.append(("host-fed scalable layer 1: f32 cache -> f32", f32_cache,
                  None, f32_rows, lambda: f32_cache, None))
    results = []
    for name, table, scale, r_, dense_fn, out_dtype in cases:
        got = gather_mean(table, r_, scale, out_dtype=out_dtype)
        torch.cuda.synchronize()
        ref = gather_mean_reference(table, r_, scale, out_dtype=out_dtype)
        err = max_abs_err(got, ref)
        big = float(ref.float().abs().max())
        tol = (2 ** -7 if got.dtype == torch.bfloat16 else 1e-5) * big
        if not (err <= tol) or got.dtype != ref.dtype \
                or got.shape != ref.shape:
            raise AssertionError(f"gather_mean {name}: max abs err {err} "
                                 f"> tol {tol} (or dtype/shape mismatch)")
        plan = launch_plan(table, r_, got, scale)
        dense = dense_fn()

        def launch_only():  # the kernel without the wrapper's host work
            gather_mean_module._launch(table, r_, scale, got, plan)
        r = {"case": name, "n": r_.shape[0], "k": r_.shape[1],
             "D": table.shape[1], "N": table.shape[0],
             "max_abs_err": err, "tol": tol, "plan": plan._asdict(),
             "out_dtype": str(got.dtype).replace("torch.", ""),
             "ms": time_ms(lambda: gather_mean(table, r_, scale,
                                               out_dtype=out_dtype)),
             "launch_only_ms": time_ms(launch_only),
             "plain_ms": time_ms(lambda: gather_mean_reference(
                 table, r_, scale, out_dtype=out_dtype)),
             "library_ms": time_ms(lambda: torch.nn.functional.embedding_bag(
                 r_, dense, mode="mean"))}
        del dense
        r.update(gather_mean_bound(table, r_, scale, got.dtype))
        r["payload_bytes"] = payload_bytes(table, r_, got.dtype)
        r["payload_gbps"] = r["payload_bytes"] / r["ms"] / 1e6
        r["bound_share"] = r["bound_ms"] / r["ms"]
        if baseline is not None and out_dtype is None:
            old = baseline_gather_mean(baseline, table, r_, scale)
            torch.cuda.synchronize()
            r["baseline_max_abs_err_vs_new"] = max_abs_err(old, got)
            if not r["baseline_max_abs_err_vs_new"] <= tol:
                raise AssertionError(f"baseline kernel disagrees on {name}")
            turns = []  # both through a thin ctypes call into one buffer
            for which in ("old", "new", "new", "old"):
                fn = ((lambda: baseline_gather_mean(baseline, table, r_,
                                                    scale, old))
                      if which == "old" else launch_only)
                turns.append((which, time_ms(fn)))
            r["turns_ms"] = turns
            log(f"  turns old/new/new/old: "
                + " / ".join(f"{t:.4f}" for _, t in turns) + " ms")
        log(f"kernel gather_mean [{name}] n={r['n']} k={r['k']} D={r['D']} "
            f"N={r['N']} plan V={plan.vec_bytes} lanes={plan.lanes} "
            f"rows/block={plan.rows_per_block} grid={plan.grid}x"
            f"{plan.col_blocks}: max_abs_err "
            f"{err:.3g} (tol {tol:.3g}); kernel_ms {r['ms']:.4f} (launch "
            f"only {r['launch_only_ms']:.4f}) "
            f"({r['payload_gbps']:.1f} GB/s payload, {r['bound_share']:.1%} "
            f"of the bound) plain_ms {r['plain_ms']:.4f} library_ms "
            f"{r['library_ms']:.4f} bound_ms {r['bound_ms']:.4f} "
            f"({r['bound_by']})")
        results.append(r)
        del got, ref
    del shifted
    if cache_rows is not None:
        del cache
    return {"cases": results, "plans": plan_sweep(q, scale_bf16, rows)}


def plan_sweep(table, scale, rows) -> list:
    """The main case at 4, 8 and 16 warps per block (launch_plan's
    default is 4). Informational."""
    out = torch.empty((rows.shape[0], table.shape[1]), dtype=scale.dtype,
                      device=table.device)
    res = []
    for rpb in (4, 8, 16):
        plan = launch_plan(table, rows, out, scale, rows_per_block=rpb)
        ms = time_ms(lambda: gather_mean_module._launch(
            table, rows, scale, out, plan))
        res.append({"plan": plan._asdict(), "ms": ms})
        log(f"  plan rows/block={rpb} grid={plan.grid}x{plan.col_blocks}: "
            f"{ms:.4f} ms")
    return res


def _check_finite(name: str, t: torch.Tensor, shape) -> None:
    if tuple(t.shape) != tuple(shape):
        raise AssertionError(f"{name}: shape {tuple(t.shape)} != {shape}")
    if not torch.isfinite(t).all():
        raise AssertionError(f"{name}: non-finite values")


def phase_slice(inf: NodeInferencer, model) -> dict:
    """The embedding export: embed_all over every node of the store."""
    inf.run(next(inf.infer_input_fn(inf.store.ids[:BATCH])))  # warm-up
    torch.cuda.synchronize()
    gather_mean.launches = 0
    t0 = time.monotonic()
    sweep = list(inf.infer_input_fn())
    t_batches = time.monotonic() - t0
    out_ids, emb = inf.embed_all(sweep)
    wall = time.monotonic() - t0
    launches = gather_mean.launches
    if launches != len(sweep):
        raise AssertionError(f"gather_mean launched {launches} times for "
                             f"{len(sweep)} forwards")
    if not np.array_equal(out_ids, inf.store.ids):
        raise AssertionError("embed_all returned the wrong ids")
    n_roots = len(out_ids)
    if emb.shape != (n_roots, 2 * DIM) or not np.isfinite(emb).all():
        raise AssertionError(f"embeddings: shape {emb.shape} or non-finite")
    per_fwd = []
    for b in sweep:
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        inf.run(b)
        stop.record()
        stop.synchronize()
        per_fwd.append(start.elapsed_time(stop))
    # kernel forward vs the same rows through the plain neighbor mean
    batch = {**sweep[0], **inf.static_batch}
    with torch.inference_mode():
        out = model(batch)
        logits = model.out(out.embedding)
        _check_finite("logits", logits, (BATCH, NUM_CLASSES))
        if not (torch.isfinite(out.loss) and torch.isfinite(out.metric)):
            raise AssertionError("non-finite loss or metric")
        rows = model.sample_rows(batch)
        table, scale = batch["feature_table"], batch["feature_scale"]
        emb_k = model.encoder(table, scale, rows)
        emb_p = model.encoder(table, scale, rows,
                              neighbor_mean=gather_mean_reference)
        logit_err = max_abs_err(model.out(emb_k), model.out(emb_p))
    fwd_err = max_abs_err(emb_k, emb_p)
    fwd_tol = 2 ** -7 * float(emb_p.abs().max())
    if not fwd_err <= fwd_tol:
        raise AssertionError(f"kernel forward vs plain forward: {fwd_err} "
                             f"> {fwd_tol}")
    edges = EDGES_PER_STEP
    ms = statistics.median(per_fwd)
    t_fwd = sum(per_fwd) / 1e3
    r = {"forwards": len(sweep), "roots": n_roots,
         "gather_mean_launches": launches, "sweep_seconds": wall,
         "batch_build_seconds": t_batches,
         "forward_seconds": t_fwd,
         "host_rest_seconds": wall - t_batches - t_fwd,
         "device_busy_share": t_fwd / wall,
         "roots_per_s": n_roots / wall,
         "edges_per_forward": edges,
         "edges_per_s": edges * len(sweep) / wall,
         "forward_ms": per_fwd, "forward_ms_median": ms,
         "device_edges_per_s": edges / (ms / 1e3),
         "kernel_vs_plain_forward_err": fwd_err,
         "kernel_vs_plain_forward_tol": fwd_tol,
         "kernel_vs_plain_logit_err": logit_err,
         "loss_batch0": float(out.loss), "metric_batch0": float(out.metric),
         "profile": profile_device(lambda: inf.run(sweep[1]),
                                   "one forward")}
    log(f"slice: {len(sweep)} forwards of {BATCH} roots over {n_roots} "
        f"nodes (fanouts {list(FANOUTS)}, dim {DIM}), gather_mean launches "
        f"{launches}; sweep {wall:.3f}s = {r['roots_per_s']:.0f} roots/s, "
        f"{r['edges_per_s']:.4g} edges/s; forward_ms median {ms:.3f} "
        f"(events) = {r['device_edges_per_s']:.4g} edges/s; kernel vs "
        f"plain forward err {fwd_err:.3g} (tol {fwd_tol:.3g}); sweep "
        f"split: batches {t_batches:.3f}s, forwards {t_fwd:.3f}s (events, "
        f"{r['device_busy_share']:.1%} of the sweep), host copies + dedup "
        f"{r['host_rest_seconds']:.3f}s")
    return r, out_ids, emb


def profile_device(fn, what: str, top_n: int = 10) -> dict:
    """One call of fn under torch.profiler: device time by kernel, and
    by kind (gather_mean, GEMMs, the rest). Informational: a profiler
    that records no device time is reported, not failed."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3

    def dev_us(e):
        return (getattr(e, "self_device_time_total", None)
                or getattr(e, "self_cuda_time_total", 0) or 0)

    # device-side kernels only: an aten op's self device time repeats
    # the time of the kernels it launched, and a record_function range
    # (e.g. Optimizer.step) shows on the device as an annotation
    rows = sorted(((dev_us(e), e.key, e.count)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)
                   and dev_us(e) > 0), reverse=True)
    busy_ms = sum(us for us, _, _ in rows) / 1e3
    top = [{"name": k[:90], "ms": us / 1e3, "calls": c}
           for us, k, c in rows[:top_n]]
    # masked_fill runs on the path only in the jnp.take fill rule:
    # take_rows (the hop-0/1 gathers) and mp_ops.gather (the conv
    # paths' row gathers); its index compares count as "other"
    kinds = {"gather_mean": 0.0, "gemm": 0.0, "masked_fill": 0.0,
             "other": 0.0}
    for us, k, _ in rows:
        kind = ("gather_mean" if "gather_mean" in k
                else "gemm" if "gemm" in k.lower()
                else "masked_fill" if "masked_fill" in k else "other")
        kinds[kind] += us / 1e3
    log(f"profile: {what}, wall {wall_ms:.3f} ms (profiled), device busy "
        f"{busy_ms:.3f} ms over {len(rows)} kernel names; gather_mean "
        f"{kinds['gather_mean']:.3f} ms, GEMMs {kinds['gemm']:.3f} ms, "
        f"the fill rule's masked fills {kinds['masked_fill']:.3f} ms, the "
        f"rest "
        f"{kinds['other']:.3f} ms")
    for t in top:
        log(f"  {t['ms']:8.3f} ms  x{t['calls']:<3d} {t['name']}")
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms, "top": top,
            "by_kind_ms": kinds,
            "gather_mean_calls": sum(c for _, k, c in rows
                                     if "gather_mean" in k)}


def phase_train(store, table, graph, dev: torch.device) -> tuple:
    """Train the flagship model through NodeEstimator on the sweep's
    tables, as bench.py times it (_drive_steps), then the index rule's
    cost and the remat check. Returns (record, the estimator)."""
    est = flagship_estimator(store, table, graph, dev)
    it = est.train_input_fn()
    r = _drive_steps(est, it, "train")
    r["index_rule"] = time_index_rule(est, est.model, it,
                                      r["profile"]["device_busy_ms"])
    r["remat"] = check_remat(est, est.model, it, dev)
    return r, est


def _drive_steps(est, it, what: str, work: str = "edges",
                 work_per_step: int = 0, kernels_per_step: int = 1,
                 batch: int = BATCH) -> dict:
    """est.train one step at a time, as bench.py times it: warm-up, then
    3 windows of steps on the host clock with a synchronize at the
    window edges only; then event-timed steps and one profiled step.
    Fails unless gather_mean launched kernels_per_step times a step, the
    loss is finite and falling and no step was skipped. work_per_step:
    the flagship's edges unless given; batch: the roots a step."""
    work_per_step = work_per_step or EDGES_PER_STEP
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gather_mean.launches = 0
    losses = est.train(it, max_steps=WARMUP_STEPS)["losses"]
    per_window = TIMED_STEPS // WINDOWS
    window_s, window_rates, metrics = [], [], []
    sums0 = _phase_sums(est)
    for _ in range(WINDOWS):
        done = est.step
        torch.cuda.synchronize()
        t0 = time.monotonic()
        res = est.train(it, max_steps=done + per_window)
        torch.cuda.synchronize()
        dt = time.monotonic() - t0
        window_s.append(dt)
        window_rates.append((res["global_step"] - done) / dt)
        losses += res["losses"]
        metrics.append(res["metric"])
    timed_s = sum(window_s)
    input_wait_ms, dispatch_ms = (
        float(x) for x in np.subtract(_phase_sums(est), sums0))
    # device time per step: CUDA events around the step itself, batches
    # built (and moved to the card) beforehand; and the host's time to
    # enqueue the step
    batches = [_on_card(next(it), est) for _ in range(EVENT_STEPS)]
    step_ms, host_ms, event_losses = [], [], []
    for b in batches:
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        loss, _ = est._train_step(b)
        stop.record()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        stop.synchronize()
        event_losses.append(loss)
        step_ms.append(start.elapsed_time(stop))
    losses += torch.stack(event_losses).cpu().tolist()
    peak = torch.cuda.max_memory_allocated()
    launches = gather_mean.launches
    steps = est.step
    skipped = int(est.skipped_steps)
    if launches != steps * kernels_per_step:
        raise AssertionError(f"{what}: gather_mean launched {launches} "
                             f"times in {steps} training steps "
                             f"({kernels_per_step} a step expected)")
    if len(losses) != steps or not np.isfinite(losses).all():
        raise AssertionError(f"{what}: non-finite training loss: {losses}")
    first5, last5 = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    if not last5 < first5:
        raise AssertionError(f"{what}: loss did not fall: first 5 mean "
                             f"{first5}, last 5 mean {last5}")
    if skipped != 0:
        raise AssertionError(f"{what}: {skipped} training steps skipped")
    prof = profile_device(lambda: est._train_step(_on_card(next(it), est)),
                          f"one {what} step", top_n=15)
    rate = work_per_step * TIMED_STEPS / timed_s
    ms = statistics.median(step_ms)
    r = {"steps": steps, "gather_mean_launches": launches,
         "skipped_steps": skipped, "losses": losses,
         "loss_first5_mean": first5, "loss_last5_mean": last5,
         "window_metrics": metrics,
         "window_seconds": window_s, "window_steps_per_s": window_rates,
         "steps_per_s": TIMED_STEPS / timed_s,
         f"{work}_per_step": work_per_step,
         f"{work}_per_sec_per_gpu": rate,
         "roots_per_s": batch * TIMED_STEPS / timed_s,
         "step_ms": step_ms, "step_ms_median": ms,
         "host_enqueue_ms": host_ms,
         "host_enqueue_ms_median": statistics.median(host_ms),
         "device_busy_share": (prof["device_busy_ms"] * TIMED_STEPS
                               / (timed_s * 1e3)),
         "input_wait_ms": input_wait_ms, "dispatch_ms": dispatch_ms,
         "peak_device_bytes": peak, "profile": prof}
    log(f"{what}: {steps} steps of {batch} roots (Adam lr {TRAIN_LR}), "
        f"gather_mean launches {launches}, skipped {skipped}; "
        f"{work}_per_sec_per_gpu {rate:.6g} ({work_per_step} {work}/step, "
        f"{r['steps_per_s']:.3f} steps/s, {r['roots_per_s']:.0f} roots/s; "
        "windows " + ", ".join(f"{x:.3f}" for x in window_rates)
        + f" steps/s); step_ms median {ms:.3f} (events), host enqueue "
        f"{r['host_enqueue_ms_median']:.3f} ms/step; device busy "
        f"{r['device_busy_share']:.1%} of the timed windows (profiled "
        f"busy ms x steps / wall); timed windows: {input_wait_ms:.1f} ms "
        f"building batches, {dispatch_ms:.1f} ms dispatching steps; "
        f"peak device memory {peak / 2**30:.2f} GiB; loss first 5 "
        f"{first5:.4f} -> last 5 {last5:.4f}; window metrics "
        + ", ".join(f"{m:.4f}" for m in metrics))
    return r


def _on_card(batch: dict, est) -> dict:
    """A batch as the estimator's step takes it (numpy arrays moved to
    its device)."""
    return base_estimator._to_device(batch, est.device)


def time_index_rule(est, model, it, step_busy_ms: float) -> dict:
    """What jnp.take's fill rule costs a step: the hop-0 and hop-1
    gathers through take_rows against plain indexing of the same rows
    (CUDA events), beside the step's profiled device time."""
    batch = {**_on_card(next(it), est), **est.static_batch}
    with torch.no_grad():
        rows = model.sample_rows(batch)[:-1]
    table = batch["feature_table"]
    ms = time_ms(lambda: [take_rows(table, r) for r in rows])
    plain = time_ms(lambda: [table[r.long()] for r in rows])
    share = (ms - plain) / step_busy_ms
    log(f"index rule: hop-0/1 gathers {ms:.4f} ms with take_rows vs "
        f"{plain:.4f} ms plain indexing (+{ms - plain:.4f} ms a step, "
        f"{share:.2%} of the profiled step's device time)")
    return {"take_rows_ms": ms, "plain_index_ms": plain,
            "added_ms": ms - plain, "step_share": share}


def check_remat(est, model, it, dev) -> dict:
    """One step's loss and gradients from the trained state with
    remat=True against the plain model: the same loss, gradients within
    1e-5 of the largest, and gather_mean launched twice (forward, and
    again in the backward pass)."""
    remat = DeviceSampledGraphSage(
        NUM_CLASSES, FEAT_DIM, multilabel=False, dim=DIM, fanouts=FANOUTS,
        uniform_sampling=model.uniform_sampling, remat=True).to(dev)
    remat.load_state_dict(model.state_dict())
    batch = {**_on_card(next(it), est), **est.static_batch}
    out = {}
    for name, m in (("plain", model), ("remat", remat)):
        m.train()
        m.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        n0 = gather_mean.launches
        res = m(batch)
        res.loss.backward()
        torch.cuda.synchronize()
        out[name] = (res.loss.detach(),
                     {n: p.grad.detach().clone()
                      for n, p in m.named_parameters()},
                     gather_mean.launches - n0,
                     torch.cuda.max_memory_allocated())
    (lp, gp, np_, mp), (lr, gr, nr, mr) = out["plain"], out["remat"]
    big = max(float(g.abs().max()) for g in gp.values())
    err = max(max_abs_err(gr[n], gp[n]) for n in gp)
    loss_diff = abs(float(lr) - float(lp))
    log(f"remat: loss {float(lr):.6f} vs {float(lp):.6f} (diff "
        f"{loss_diff:.3g}), max grad err {err:.3g} (tol {1e-5 * big:.3g}), "
        f"gather_mean launches {nr} vs {np_}; peak device memory "
        f"{mr / 2**30:.2f} vs {mp / 2**30:.2f} GiB")
    if not (loss_diff == 0.0 and err <= 1e-5 * big and nr == 2 and np_ == 1):
        raise AssertionError("remat step disagrees with the plain step")
    return {"loss_diff": loss_diff, "max_grad_err": err,
            "grad_tol": 1e-5 * big, "launches": nr, "plain_launches": np_,
            "peak_bytes": mr, "plain_peak_bytes": mp}


def with_layout(est, layout=None):
    """The estimator's neighbor tables replaced by a layout's (the fused
    table alone, or the split tables with the alias table): its static
    batch holds the tables the model reads."""
    if layout is not None:
        for k in ("nbr_table", "cum_table", "nbrcum_table", "alias_table"):
            est.static_batch.pop(k, None)
        est.static_batch.update(layout)
    return est


def flagship_estimator(store, table, graph, dev, layout=None,
                       uniform=None, mesh=None, model_dir=None, **cfg):
    """The flagship model (random weights from seed 0) in a NodeEstimator
    over the path's tables (or a layout's, with_layout), with bench.py's
    training parameters (cfg overrides them). uniform: the model's
    uniform_sampling (default the table's uniform_rows, bench.py's
    auto)."""
    model = DeviceSampledGraphSage(
        NUM_CLASSES, FEAT_DIM, multilabel=False, dim=DIM, fanouts=FANOUTS,
        uniform_sampling=table.uniform_rows if uniform is None else uniform,
        generator=torch.Generator().manual_seed(0))
    return with_layout(NodeEstimator(
        model, {**dict(batch_size=BATCH, learning_rate=TRAIN_LR,
                       optimizer="adam", log_steps=1 << 30,
                       checkpoint_steps=0, train_node_type=-1, seed=0),
                **cfg},
        graph, None, model_dir=model_dir, feature_store=store,
        device_sampler=table, device=dev, mesh=mesh), layout)


def phase_loop(store, table, graph, dev, k: int = LOOP_K) -> tuple:
    """NodeEstimator.train at steps_per_loop = k (32) as bench.py drives it:
    the prefetch thread (depth 3) builds each batch and copies its roots
    to the card; K + 2 warm-up steps; 3 timed windows on the host clock
    with a synchronize at the window edges only. Returns (record, the
    estimator)."""
    est = flagship_estimator(store, table, graph, dev,
                             steps_per_loop=k)
    it = make_feeder(est.train_input_fn(), workers=0, depth=FEEDER_DEPTH,
                     transform=lambda b: _on_card(b, est))
    try:
        return _drive_loop(est, it, k), est
    finally:
        it.close()


def _phase_sums(est) -> tuple:
    """Host ms summed so far in the estimator's input_wait and
    device_step phases (obs histograms)."""
    return (est._hist_input_wait.value["sum"],
            est._hist_device_step.value["sum"])


def _drive_loop(est, it, k: int, what: str = "loop", work: str = "edges",
                work_per_step: int = 0, kernels_per_step: int = 1,
                batch: int = BATCH, n_windows: int = WINDOWS) -> dict:
    """est.train at steps_per_loop = k as bench.py drives it: k + 2
    warm-up steps (the first window eager, the capture, a tail of 2),
    n_windows (3) timed windows of 64 steps; then event-timed replays
    and one profiled replay. Fails unless gather_mean's launches on the
    card (eager + recorded per window x replays) are kernels_per_step
    per step, the loss is finite and falling and no step was skipped.
    work_per_step: the flagship's edges unless given; batch: the roots
    a step."""
    work_per_step = work_per_step or EDGES_PER_STEP
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gather_mean.launches = 0
    warm = k + 2
    t0 = time.monotonic()
    losses = est.train(iter([next(it) for _ in range(warm)]),
                       max_steps=warm)["losses"]
    torch.cuda.synchronize()
    warm_s = time.monotonic() - t0
    window_s, window_rates, metrics = [], [], []
    sums0 = _phase_sums(est)
    for _ in range(n_windows):
        done = est.step
        torch.cuda.synchronize()
        t0 = time.monotonic()
        res = est.train(it, max_steps=done + LOOP_WINDOW_STEPS)
        torch.cuda.synchronize()
        dt = time.monotonic() - t0
        window_s.append(dt)
        window_rates.append((res["global_step"] - done) / dt)
        losses += res["losses"]
        metrics.append(res["metric"])
    input_wait_ms, dispatch_ms = (
        float(x) for x in np.subtract(_phase_sums(est), sums0))
    launches = gather_mean.launches
    loop = est._graphed
    steps, replays = est.step, loop.replays
    per_replay = loop.launches_per_replay
    eager = launches - loop.captures * per_replay
    device_launches = eager + replays * per_replay
    peak = torch.cuda.max_memory_allocated()
    skipped = int(est.skipped_steps)
    if (per_replay != k * kernels_per_step
            or device_launches != steps * kernels_per_step
            or (kernels_per_step and eager <= 0)):
        raise AssertionError(
            f"{what}: gather_mean: {launches} host launches, {per_replay} "
            f"recorded per {k}-step window, {loop.captures} captures, "
            f"{replays} replays: {device_launches} launches on the "
            f"card for {steps} steps")
    if len(losses) != steps or not np.isfinite(losses).all():
        raise AssertionError(f"{what}: non-finite training loss: {losses}")
    first5, last5 = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    if not last5 < first5 or skipped != 0:
        raise AssertionError(f"{what}: loss first 5 {first5} -> last 5 "
                             f"{last5}, {skipped} skipped steps")
    # one replay at a time: CUDA events around it, the host's time to
    # enqueue it (copies of the window's roots, re-seeding, replay,
    # clones), batches prebuilt
    replay_ms, host_ms = [], []
    for _ in range(n_windows):
        window = [_on_card(next(it), est) for _ in range(k)]
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        loop.run(est, window)
        stop.record()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        stop.synchronize()
        replay_ms.append(start.elapsed_time(stop))
    windows = [[_on_card(next(it), est) for _ in range(k)]
               for _ in range(2)]
    prof = profile_device(lambda: loop.run(est, windows.pop()),
                          f"one replay of the {k}-step {what} graph",
                          top_n=15)
    if prof["device_busy_ms"] > 0 \
            and prof["gather_mean_calls"] != k * kernels_per_step:
        raise AssertionError(f"{what}: {prof['gather_mean_calls']} "
                             f"gather_mean kernels in one {k}-step replay")
    timed_steps = n_windows * LOOP_WINDOW_STEPS
    timed_s = sum(window_s)
    eps = work_per_step * timed_steps / timed_s
    busy_step_ms = prof["device_busy_ms"] / k
    r = {"steps_per_loop": k, "feeder_depth": FEEDER_DEPTH,
         "steps": steps, "warmup_steps": warm, "warmup_seconds": warm_s,
         "gather_mean_host_launches": launches,
         "gather_mean_launches_per_replay": per_replay,
         "captures": loop.captures, "replays": replays,
         "gather_mean_device_launches": device_launches,
         "skipped_steps": skipped, "losses": losses,
         "loss_first5_mean": first5, "loss_last5_mean": last5,
         "window_seconds": window_s, "window_steps_per_s": window_rates,
         "window_metrics": metrics,
         "steps_per_s": timed_steps / timed_s,
         f"{work}_per_step": work_per_step,
         f"{work}_per_sec_per_gpu": eps,
         "roots_per_s": batch * timed_steps / timed_s,
         "replay_ms": replay_ms, "replay_ms_median": statistics.median(
             replay_ms),
         "host_ms_per_replay": host_ms,
         "host_ms_per_step": statistics.median(host_ms) / k,
         "device_busy_ms_per_step": busy_step_ms,
         "device_busy_share": busy_step_ms * timed_steps / (timed_s * 1e3),
         "replay_busy_share": prof["device_busy_ms"] / prof["wall_ms"],
         "input_wait_ms": input_wait_ms, "dispatch_ms": dispatch_ms,
         f"device_{work}_per_s": work_per_step * k / (
             statistics.median(replay_ms) / 1e3),
         "peak_device_bytes": peak, "profile": prof}
    log(f"{what}: {steps} steps at steps_per_loop {k} ({loop.captures} "
        f"capture, {replays} replays), gather_mean {launches} host "
        f"launches, {per_replay} per replayed window, {device_launches} on "
        f"the card ({kernels_per_step} a step); {work}_per_sec_per_gpu "
        f"{eps:.6g} ({r['steps_per_s']:.3f} steps/s, "
        f"{r['roots_per_s']:.0f} roots/s; windows "
        + ", ".join(f"{x:.3f}" for x in window_rates)
        + f" steps/s); replay {r['replay_ms_median']:.3f} ms (events) = "
        f"{r['replay_ms_median'] / k:.3f} ms/step; host "
        f"{r['host_ms_per_step']:.4f} ms/step to enqueue; device busy "
        f"{r['device_busy_share']:.1%} of the timed windows, "
        f"{r['replay_busy_share']:.1%} of the profiled replay; "
        f"{prof['gather_mean_calls']} gather_mean kernels in it; timed "
        f"windows: {input_wait_ms:.1f} ms waiting for batches, "
        f"{dispatch_ms:.1f} ms dispatching; peak "
        f"device memory {peak / 2**30:.2f} GiB; loss first 5 {first5:.4f} "
        f"-> last 5 {last5:.4f}; window metrics "
        + ", ".join(f"{m:.4f}" for m in metrics))
    return r


def _run_diffs(a, b) -> dict:
    """Largest differences between two training runs (est, losses):
    losses, every state_dict entry (parameters and buffers, the
    activation caches too) and Adam's state."""
    (ea, la), (eb, lb) = a, b
    diffs = {"losses": float(np.max(np.abs(np.subtract(la, lb))))}
    sd_a = ea.model.state_dict()
    for name, p in eb.model.state_dict().items():
        diffs[name] = max_abs_err(sd_a[name], p)
    sa, sb = (e.optimizer.state_dict()["state"] for e in (ea, eb))
    for i in sb:
        for n in sb[i]:
            diffs[f"adam[{i}].{n}"] = max_abs_err(sa[i][n], sb[i][n])
    return diffs


def check_graph_vs_eager(make_estimator, feed, k: int = LOOP_K,
                         what: str = "flagship", against=None) -> dict:
    """LOOP_EQ_WINDOWS windows of k steps at K = k (the first eager on
    the capture stream, the rest graph replays) and at K = 1, from the
    same weights on the same batches: losses, parameters, buffers and
    Adam's moments and steps equal bit for bit. make_estimator(K) builds
    the estimator; feed gives the batches. against: an optional (label,
    make_estimator) whose run at K = k on the same batches must equal
    the graph run bit for bit too (the fused layout against the split
    tables' weighted draw)."""
    steps = LOOP_EQ_WINDOWS * k
    batches = [next(feed) for _ in range(steps)]
    runs = []
    for spl in (k, 1):
        est = make_estimator(spl)
        res = est.train(iter(batches), max_steps=steps)
        runs.append((est, res["losses"]))
    diffs = _run_diffs(*runs)
    worst = max(diffs.values())
    eg = runs[0][0]
    replays = eg._graphed.replays
    log(f"graph vs eager ({what}): {steps} steps at K = {k} ({replays} "
        f"replays) and K = 1 from the same weights and batches: largest "
        f"difference {worst:.3g} over losses, {len(diffs) - 1} state "
        f"tensors (parameters, buffers, Adam) (bit for bit: "
        f"{worst == 0.0})")
    if not (worst == 0.0 and replays == LOOP_EQ_WINDOWS - 1):
        raise AssertionError(f"{what}: graph replay differs from the eager "
                             f"steps: {diffs}")
    out = {"steps": steps, "steps_per_loop": k, "replays": replays,
           "gather_mean_launches_per_replay": eg._graphed.launches_per_replay,
           "max_abs_diff": worst, "diffs": diffs}
    if against is not None:
        label, make = against
        est = make(k)
        res = est.train(iter(batches), max_steps=steps)
        d2 = _run_diffs(runs[0], (est, res["losses"]))
        w2 = max(d2.values())
        log(f"{what} vs {label}: {steps} steps at K = {k} from the same "
            f"weights and batches: largest difference {w2:.3g} (bit for "
            f"bit: {w2 == 0.0})")
        if w2 != 0.0:
            raise AssertionError(f"{what} differs from {label}: {d2}")
        out[f"vs_{label}"] = {"max_abs_diff": w2, "diffs": d2}
    return out


# phase 9m: the mesh windows (K = LOOP_K), the sharded model's steps
# (K = MESH_SHARDED_K) and the small card-vs-CPU check's roots and width;
# the export's bounded sweep (batches of infer_input_fn) and the steps of
# the activation cache and the LINE and TransE runners' models
MESH_WINDOWS, MESH_SHARDED_K, MESH_SHARDED_STEPS = 2, 4, 8
MESH_ID_DIM, MESH_SMALL_ROOTS, MESH_SMALL_DIM, MESH_SMALL_LR = 16, 64, 16, 0.05
MESH_EXPORT_STEPS, MESH_CACHE_STEPS, MESH_RUNNER_STEPS = 8, 2, 3


def _sharded_sage(dim: int, device) -> torch.nn.Module:
    return ShardedSupervisedGraphSage(
        NUM_CLASSES, FEAT_DIM, multilabel=False, dim=dim, fanouts=FANOUTS,
        max_id=FULL_NODES - 1, id_dim=MESH_ID_DIM,
        generator=torch.Generator().manual_seed(0)).to(device)


def _sharded_batches(sampler, static: dict, feed, n: int,
                     roots: int = BATCH) -> list:
    """n host-fed batches for ShardedSupervisedGraphSage on the card:
    the flagship's sampler draws each batch's [15, 10] rows (the row is
    the node id), their features are the int8 table's rows dequantized,
    the labels the label table's."""
    out = []
    with torch.no_grad():
        for _ in range(n):
            b = _on_card(next(feed), sampler)
            b = {**b, "rows": [b["rows"][0][:roots]], **static}
            rows = sampler.model.sample_rows(b)
            out.append({
                "ids": rows,
                "layers": [dequantize_rows(static["feature_table"][r.long()],
                                           static["feature_scale"])
                           for r in rows],
                "labels": static["label_table"][rows[0].long()]})
    return out


def _replay_ms(est, batches, k: int, n: int = 3) -> float:
    """Median of n event-timed replays of est's K-step graph."""
    loop, times = est._graphed, []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        loop.run(est, batches[:k])
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def _flat_state(model_sd: dict, opt_sd: dict) -> dict:
    """{"model/<key>" or "opt/<index>/<key>": tensor} of a model and an
    optimizer state_dict."""
    out = {f"model/{k}": v for k, v in model_sd.items()}
    for i, st in opt_sd["state"].items():
        for k, v in st.items():
            out[f"opt/{i}/{k}"] = v
    return out


def _live_state(est) -> dict:
    """An estimator's whole model and optimizer state (gathered over its
    mesh), on the CPU."""
    return _flat_state(gather_state_dict(est.model),
                       gather_optimizer_state_dict(est.optimizer))


def _file_state(est) -> dict:
    """The model and optimizer state of an estimator's latest
    checkpoint file."""
    p = torch.load(est._checkpoints()[-1][1], map_location="cpu",
                   weights_only=True)
    return _flat_state(p["model"], p["optimizer"])


def _unequal(a: dict, b: dict) -> list:
    """The keys of two flat states whose tensors differ in dtype, shape
    or any bit (a key in one only counts)."""
    def raw(t):
        return t.detach().cpu().contiguous().reshape(-1).view(torch.uint8)

    return sorted(k for k in a.keys() | b.keys()
                  if k not in a or k not in b or a[k].dtype != b[k].dtype
                  or a[k].shape != b[k].shape
                  or not torch.equal(raw(a[k]), raw(b[k])))


def _round_trip(est, fresh) -> tuple:
    """est's latest checkpoint against its live state, and restored into
    fresh() (an estimator built as est was, over est's model_dir) against
    the file: (record, the file's state); fails unless both are bit for
    bit."""
    t0 = time.monotonic()
    path = est._checkpoints()[-1][1]
    file = _file_state(est)
    restored = fresh()
    restored.model_dir = est.model_dir
    step = restored.restore_checkpoint()
    bad = {"file_vs_live": _unequal(file, _live_state(est)),
           "restored_vs_file": _unequal(_live_state(restored), file)}
    del restored
    r = {"file": os.path.basename(path), "step": step,
         "tensors": len(file), "bytes": os.path.getsize(path),
         "load_restore_compare_seconds": time.monotonic() - t0,
         "unequal": bad}
    if any(bad.values()) or step != est.step:
        raise AssertionError(f"mesh: checkpoint round trip {r}")
    return r, file


def _mesh_export(runs, root: str) -> dict:
    """(ii) export_bundle from the unmeshed and the meshed flagship over
    MESH_EXPORT_STEPS batches of infer_input_fn: parameters, ids and
    embeddings bit for bit, gather_mean once a forward."""
    got = {}
    for tag, (est, _) in zip(("plain", "mesh"), runs):
        torch.cuda.synchronize()
        gather_mean.launches = 0
        t0 = time.monotonic()
        b = est.export_bundle(os.path.join(root, tag, "bundle"),
                              steps=MESH_EXPORT_STEPS, index=False)
        torch.cuda.synchronize()
        got[tag] = (b, gather_mean.launches, time.monotonic() - t0)
    (a, la, ta), (b, lb, tb) = got["plain"], got["mesh"]
    bad = sorted(set(a.params) ^ set(b.params)) + [
        k for k in a.params if k in b.params
        and a.params[k].tobytes() != b.params[k].tobytes()]
    if a.ids.tobytes() != b.ids.tobytes():
        bad.append("ids")
    if a.embeddings.tobytes() != b.embeddings.tobytes():
        bad.append("embeddings")
    r = {"forwards": MESH_EXPORT_STEPS, "rows": b.count, "dim": b.dim,
         "params": len(b.params), "gather_mean_launches": [la, lb],
         "seconds": [ta, tb], "unequal": bad}
    log(f"mesh: export_bundle over {MESH_EXPORT_STEPS} batches, {b.count} "
        f"ids x {b.dim}: the meshed bundle against the unmeshed one, "
        f"{len(b.params)} parameters, ids and embeddings unequal: "
        f"{bad or 'none'} (bit for bit); gather_mean launches {la} / {lb} "
        f"for {MESH_EXPORT_STEPS} forwards; {ta:.2f} / {tb:.2f} s")
    if bad or la != MESH_EXPORT_STEPS or lb != MESH_EXPORT_STEPS \
            or b.count != MESH_EXPORT_STEPS * BATCH:
        raise AssertionError(f"mesh: export {r}")
    return r


def _mesh_act_cache(store, table, graph, mesh, dev) -> dict:
    """(iv) The activation-cache estimator with and without the mesh,
    MESH_CACHE_STEPS steps on the same batches, then shard_act_cache (a
    model axis of 1 keeps the caches whole) and refresh_act_cache: the
    whole state, the caches included, bit for bit; gather_mean's
    launches of each refresh."""
    t0 = time.monotonic()
    ests = {tag: cache_estimator(store, table, graph, dev, mesh=m)
            for tag, m in (("plain", None), ("mesh", mesh))}
    feed = ests["plain"].train_input_fn()
    batches = [next(feed) for _ in range(MESH_CACHE_STEPS)]
    for est in ests.values():
        est.train(iter(batches), max_steps=MESH_CACHE_STEPS)
    shard_act_cache(ests["mesh"], mesh)
    launches = {}
    for tag, est in ests.items():
        torch.cuda.synchronize()
        gather_mean.launches = 0
        refresh_act_cache(est, chunk=CACHE_CHUNK)
        torch.cuda.synchronize()
        launches[tag] = gather_mean.launches
    bad = _unequal(_live_state(ests["plain"]), _live_state(ests["mesh"]))
    h = ests["mesh"].model.encoder.cache_1.h
    chunks = -(-(int(store.features.shape[0]) - 1) // CACHE_CHUNK)
    r = {"steps": MESH_CACHE_STEPS, "chunks": chunks,
         "gather_mean_launches": launches, "unequal": bad,
         "pad_row_zero": not bool(h[-1].any()),
         "seconds": time.monotonic() - t0}
    log(f"mesh: the activation cache {MESH_CACHE_STEPS} steps, "
        f"shard_act_cache and refresh_act_cache over {chunks} chunks with "
        f"the mesh against without: unequal tensors {bad or 'none'} (bit "
        f"for bit); gather_mean launches {launches['mesh']} / "
        f"{launches['plain']} a refresh; {r['seconds']:.1f} s")
    if bad or not r["pad_row_zero"] or launches["mesh"] != \
            launches["plain"] or launches["mesh"] != CACHE_LAYERS * chunks:
        raise AssertionError(f"mesh: act cache {r}")
    return r


def _mesh_runners(mesh, dev) -> dict:
    """(v) LINE (split over the data axis) as run_line builds it
    host-fed (run_line.py:88-97: cora, dim 128, lr 0.025) and TransE
    (replicated) as run_transx's kg_estimator builds it (fb15k237, dim
    64, margin 1, lr 0.01), each through BaseEstimator with and without
    the mesh, MESH_RUNNER_STEPS steps on the same batches from their
    runners' input streams: losses and state bit for bit."""
    t0 = time.monotonic()
    data = common.load_graph("cora", 0)
    g = data.engine

    def line_batch():
        src, dst, _ = g.sample_edge(512, -1)
        negs = g.sample_node(512 * 5, -1).reshape(512, 5)
        return {"src": src, "pos": dst, "negs": negs, "infer_ids": src}

    kg = common.load_graph("fb15k237", 0)
    triples = run_transx.triple_input_fn(
        kg.engine, kg.num_entities, 256, 16, np.random.default_rng(0))()
    builds = {
        "line": (lambda m: BaseEstimator(
            LINE(data.max_id, dim=128, order=2,
                 generator=torch.Generator().manual_seed(0)),
            dict(learning_rate=0.025, max_id=data.max_id, seed=0),
            device=dev, mesh=m),
            [line_batch() for _ in range(MESH_RUNNER_STEPS)]),
        "transe": (lambda m: BaseEstimator(
            TransE(num_entities=kg.num_entities,
                   num_relations=kg.num_relations, dim=64, margin=1.0,
                   generator=torch.Generator().manual_seed(0)),
            dict(learning_rate=0.01, seed=0), device=dev, mesh=m),
            [next(triples) for _ in range(MESH_RUNNER_STEPS)]),
    }
    r = {}
    for name, (build, batches) in builds.items():
        runs = []
        for m in (None, mesh):
            est = build(m)
            runs.append((est, est.train(iter(batches),
                                        max_steps=MESH_RUNNER_STEPS)
                         ["losses"]))
        diffs = _run_diffs(*runs)
        r[name] = {"splits_over_data": bool(getattr(
            runs[1][0].model, "splits_over_data", False)),
            "losses": runs[1][1], "max_abs_diff": max(diffs.values())}
    r["seconds"] = time.monotonic() - t0
    log("mesh: " + "; ".join(
        f"{n} ({'split' if v['splits_over_data'] else 'replicated'}) "
        f"{MESH_RUNNER_STEPS} steps with the mesh against without: largest "
        f"difference {v['max_abs_diff']:.3g} (bit for bit: "
        f"{v['max_abs_diff'] == 0.0})" for n, v in r.items()
        if n != "seconds") + f"; {r['seconds']:.1f} s")
    if any(v["max_abs_diff"] != 0.0 or not np.isfinite(v["losses"]).all()
           for n, v in r.items() if n != "seconds"):
        raise AssertionError(f"mesh: runners {r}")
    return r


def phase_mesh(store, table, graph, dev) -> dict:
    """Phase 9m (see the module docstring). Fails unless the meshed
    flagship equals the unmeshed one bit for bit, its graph holds one
    collective a step and K gather_mean launches, its checkpoint and its
    bounded export equal the unmeshed ones bit for bit and restore bit
    for bit, the sharded model's loss is finite and falls and its
    checkpoint restores bit for bit, the small model on the card stays
    within its tolerances of the CPU's, the activation cache's refresh
    and the LINE and TransE steps equal their unmeshed runs bit for
    bit."""
    t0 = time.monotonic()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "build", "chip_smoke_mesh")
    shutil.rmtree(root, ignore_errors=True)
    initialize_multihost(MultihostConfig(f"127.0.0.1:{free_port()}", 1, 0),
                         device=dev)
    try:
        mesh = make_mesh(device=dev)
        # the communicator starts on an eager collective, before any
        # capture
        collectives.all_reduce(torch.ones(1, device=dev), mesh.group("data"))
        torch.cuda.synchronize()
        k = LOOP_K
        steps = MESH_WINDOWS * k
        feed = flagship_estimator(store, table, graph, dev).train_input_fn()
        batches = [next(feed) for _ in range(steps)]
        runs, rec = [], {}
        for tag, m in (("plain", None), ("mesh", mesh)):
            est = flagship_estimator(store, table, graph, dev, mesh=m,
                                     steps_per_loop=k,
                                     checkpoint_steps=steps,
                                     model_dir=os.path.join(root, tag))
            gather_mean.launches = 0
            collectives.reset_counts()
            res = est.train(iter(batches), max_steps=steps)
            loop = est._graphed
            rec[tag] = {"captures": loop.captures, "replays": loop.replays,
                        "collectives_per_replay": loop.collectives_per_replay,
                        "collectives_host": collectives.total_count(),
                        "gather_mean_launches_per_replay":
                            loop.launches_per_replay,
                        "gather_mean_host_launches": gather_mean.launches}
            runs.append((est, res["losses"]))
        diffs = _run_diffs(*runs)
        worst = max(diffs.values())
        # (i) the checkpoints train() wrote, the meshed one restored
        ckpt, file = _round_trip(runs[1][0], lambda: flagship_estimator(
            store, table, graph, dev, mesh=mesh))
        ckpt["mesh_vs_plain_file"] = _unequal(file, _file_state(runs[0][0]))
        log(f"mesh: the flagship's checkpoint {ckpt['file']} "
            f"({ckpt['tensors']} tensors, {ckpt['bytes']} bytes) with the "
            f"mesh against without, unequal: "
            f"{ckpt['mesh_vs_plain_file'] or 'none'}; against the live "
            f"state and restored into a fresh meshed estimator: "
            f"{ckpt['unequal']} (bit for bit); "
            f"{ckpt['load_restore_compare_seconds']:.2f} s")
        if ckpt["mesh_vs_plain_file"]:
            raise AssertionError(f"mesh: checkpoint {ckpt}")
        del file
        export = _mesh_export(runs, root)
        window = [_on_card(b, runs[0][0]) for b in batches[:k]]
        for tag, (est, _) in zip(("plain", "mesh"), runs):
            rec[tag]["replay_ms"] = _replay_ms(est, window, k)
        per_step = rec["mesh"]["collectives_per_replay"] / k
        nccl_ms = (rec["mesh"]["replay_ms"] - rec["plain"]["replay_ms"]) / k
        log(f"mesh: NCCL world of one, mesh {mesh.shape}; the flagship at "
            f"K = {k}, {steps} steps with and without the mesh: largest "
            f"difference {worst:.3g} over losses and "
            f"{len(diffs) - 1} state tensors (bit for bit: {worst == 0.0});"
            f" {per_step:g} collectives a step in the captured graph "
            f"({rec['mesh']['collectives_host']} issued on the host), "
            f"gather_mean {rec['mesh']['gather_mean_launches_per_replay']} "
            f"launches a replayed window; replay "
            f"{rec['mesh']['replay_ms']:.3f} ms with the mesh, "
            f"{rec['plain']['replay_ms']:.3f} ms without "
            f"({nccl_ms * 1e3:.1f} us a step)")
        if worst != 0.0 or per_step != 1 \
                or rec["mesh"]["gather_mean_launches_per_replay"] != k \
                or rec["mesh"]["replays"] != MESH_WINDOWS - 1:
            raise AssertionError(f"mesh: {rec}, diffs {diffs}")
        out = {"flagship": rec, "max_abs_diff": worst,
               "collectives_per_step": per_step,
               "nccl_ms_per_step": nccl_ms, "checkpoint": ckpt,
               "export": export}
        del runs, window
        sampler = flagship_estimator(store, table, graph, dev)
        static = dict(sampler.static_batch)
        out["sharded"] = _mesh_sharded(sampler, static, feed, mesh, dev,
                                       os.path.join(root, "sharded"))
        out["small"] = _mesh_small_vs_cpu(sampler, static, feed, mesh, dev)
        del sampler, static
        out["act_cache"] = _mesh_act_cache(store, table, graph, mesh, dev)
        out["runners"] = _mesh_runners(mesh, dev)
    finally:
        finalize_multihost()
        shutil.rmtree(root, ignore_errors=True)
    out["memory_plan"] = {
        f"{n}_cards": plan_tables(FULL_NODES, cap=CAP, feat_dim=FEAT_DIM,
                                  label_dim=NUM_CLASSES, mp=n)
        for n in (1, 4)}
    out["memory_plan"]["partitioned_4_cards"] = plan_partitioned_table(
        FULL_NODES, feat_dim=FEAT_DIM, k_shards=4, hub_cache_frac=0.01,
        label_dim=NUM_CLASSES, chip="h100")
    log("mesh: memory_plan (arithmetic, not measured): the flagship's "
        "tables " + ", ".join(
            f"{v['per_chip_total_bytes']} bytes a card at {n}"
            for n, v in ((1, out["memory_plan"]["1_cards"]),
                         (4, out["memory_plan"]["4_cards"])))
        + "; the feature table partitioned over 4 with a 1% hub cache "
        + f"{out['memory_plan']['partitioned_4_cards']['per_chip_total_bytes']}"
        " bytes a card")
    out["seconds"] = time.monotonic() - t0
    log(f"mesh: phase 9m took {out['seconds']:.1f} s")
    return out


def _mesh_sharded(sampler, static, feed, mesh, dev, model_dir: str) -> dict:
    """ShardedSupervisedGraphSage at full width through the meshed
    estimator: MESH_SHARDED_STEPS steps at K = MESH_SHARDED_K on one
    batch (its loss falls); then (iii) its checkpoint (the id table and
    Adam's moments of it) in model_dir against the live state and
    restored into a fresh meshed estimator, bit for bit."""
    k, n = MESH_SHARDED_K, MESH_SHARDED_STEPS
    cfg = dict(batch_size=BATCH, learning_rate=TRAIN_LR, optimizer="adam",
               log_steps=1 << 30, checkpoint_steps=0, train_node_type=-1,
               seed=0, steps_per_loop=k)
    est = NodeEstimator(_sharded_sage(DIM, dev), cfg, None, None,
                        model_dir=model_dir, mesh=mesh, device=dev)
    batches = _sharded_batches(sampler, static, feed, 1) * n
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    losses = est.train(iter(batches), max_steps=n)["losses"]
    torch.cuda.synchronize()
    secs = time.monotonic() - t0
    replay_ms = _replay_ms(est, batches, k)
    r = {"steps": n, "steps_per_loop": k, "losses": losses,
         "replays": est._graphed.replays, "seconds": secs,
         "replay_ms": replay_ms,
         "collectives_per_replay": est._graphed.collectives_per_replay,
         "peak_device_bytes": torch.cuda.max_memory_allocated()}
    log(f"mesh: ShardedSupervisedGraphSage (id_dim {MESH_ID_DIM}, dim "
        f"{DIM}, fanouts {list(FANOUTS)}, {BATCH} roots) {n} steps at "
        f"K = {k}: losses {losses[0]:.4f} -> {losses[-1]:.4f}, replay "
        f"{replay_ms:.3f} ms ({replay_ms / k:.3f} ms a step), "
        f"{r['collectives_per_replay']} collectives a replay, peak "
        f"{r['peak_device_bytes'] / 2**30:.2f} GiB")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"mesh: sharded model losses {losses}")
    t0 = time.monotonic()
    est.save_checkpoint(est.step)
    save_s = time.monotonic() - t0
    r["checkpoint"], _ = _round_trip(est, lambda: NodeEstimator(
        _sharded_sage(DIM, dev), cfg, None, None, mesh=mesh, device=dev))
    r["checkpoint"]["save_seconds"] = save_s
    log(f"mesh: ShardedSupervisedGraphSage's checkpoint "
        f"{r['checkpoint']['file']} ({r['checkpoint']['bytes']} bytes, the "
        f"id table and Adam's moments of it) saved in {save_s:.2f} s, "
        f"against the live state and restored into a fresh meshed "
        f"estimator: {r['checkpoint']['unequal']} (bit for bit); "
        f"{r['checkpoint']['load_restore_compare_seconds']:.2f} s")
    return r


def _step1_grads(model: torch.nn.Module, batch: dict) -> dict:
    """Each leaf's gradient of one training forward's loss, float64 on
    the CPU."""
    model.train()
    model(batch).loss.backward()
    return {n: p.grad.detach().cpu().double()
            for n, p in model.named_parameters() if p.grad is not None}


def _as_f64(batch: dict) -> dict:
    return {k: [t.double() for t in v] if k == "layers" else
            v.double() if k == "labels" else v for k, v in batch.items()}


def _mesh_small_vs_cpu(sampler, static, feed, mesh, dev) -> dict:
    """The sharded model at dim MESH_SMALL_DIM on MESH_SMALL_ROOTS roots
    under Adam, 1 + MESH_WINDOWS·K steps at K = MESH_SHARDED_K (an eager
    window, replays, a tail step):
    (a) float32 on the card with the mesh against the card without one
        at K = 1: losses, state and Adam's state bit for bit;
    (b) step 1's float32 gradients on the card and on the CPU against
        the CPU's float64 ones: leaf by leaf, the card's error within
        4x the CPU's + 1e-6 of the leaf's largest gradient (a float32
        Adam run of the two devices parts all the same: Adam moves a
        weight by about lr on the sign of any gradient above its eps,
        whichever way rounding set it);
    (c) float64 on the card with the mesh against float64 on the CPU
        without one: losses within 1e-9 relative and every parameter
        within 1e-9 of its leaf's largest."""
    k = MESH_SHARDED_K
    n = 1 + MESH_WINDOWS * k
    card = _sharded_batches(sampler, static, feed, n, MESH_SMALL_ROOTS)
    cpu = [{key: [t.cpu() for t in v] if isinstance(v, list) else v.cpu()
            for key, v in b.items()} for b in card]
    cfg = dict(batch_size=MESH_SMALL_ROOTS, learning_rate=MESH_SMALL_LR,
               optimizer="adam", log_steps=1 << 30, checkpoint_steps=0,
               train_node_type=-1, seed=0)

    def train(model, batches, device, meshed):
        est = NodeEstimator(model, {**cfg, "steps_per_loop":
                                    k if meshed else 1}, None, None,
                            mesh=mesh if meshed else None, device=device)
        return est, est.train(iter(batches), max_steps=n)["losses"]

    # (a)
    runs = [train(_sharded_sage(MESH_SMALL_DIM, dev), card, dev, m)
            for m in (True, False)]
    diffs = _run_diffs(*runs)
    a_worst = max(diffs.values())
    replays = runs[0][0]._graphed.replays
    # (b)
    g64 = _step1_grads(_sharded_sage(MESH_SMALL_DIM, "cpu").double(),
                       _as_f64(cpu[0]))
    g_card = _step1_grads(_sharded_sage(MESH_SMALL_DIM, dev), card[0])
    g_cpu = _step1_grads(_sharded_sage(MESH_SMALL_DIM, "cpu"), cpu[0])
    grads = {}
    for name, ref in g64.items():
        scale = float(ref.abs().max()) or 1.0
        grads[name] = {
            "max_abs_grad": scale,
            "card_err": float((g_card[name] - ref).abs().max()) / scale,
            "cpu_err": float((g_cpu[name] - ref).abs().max()) / scale}
    b_bad = [name for name, v in grads.items()
             if v["card_err"] > 4 * v["cpu_err"] + 1e-6]
    # (c)
    e64, l64 = train(_sharded_sage(MESH_SMALL_DIM, dev).double(),
                     [_as_f64(b) for b in card], dev, True)
    c64, m64 = train(_sharded_sage(MESH_SMALL_DIM, "cpu").double(),
                     [_as_f64(b) for b in cpu], "cpu", False)
    rel = float(np.max(np.abs(np.subtract(l64, m64)) / np.abs(m64)))
    whole = gather_state_dict(e64.model)
    p_rel = max(float((whole[name] - p.detach()).abs().max())
                / (float(p.detach().abs().max()) or 1.0)
                for name, p in c64.model.named_parameters())
    log(f"mesh: ShardedSupervisedGraphSage dim {MESH_SMALL_DIM} on "
        f"{MESH_SMALL_ROOTS} roots, Adam, {n} steps at K = {k} "
        f"({replays} replays): (a) float32 with the mesh vs without on "
        f"the card: largest difference {a_worst:.3g} over losses and "
        f"{len(diffs) - 1} state tensors (bit for bit: {a_worst == 0.0});"
        f" (b) step 1's float32 gradients against float64, the largest "
        f"error of a leaf: card {max(v['card_err'] for v in grads.values()):.3g}"
        f", CPU {max(v['cpu_err'] for v in grads.values()):.3g} "
        f"(leaves past 4x the CPU's + 1e-6: {b_bad or 'none'}); (c) "
        f"float64, card with the mesh vs CPU: largest relative loss "
        f"difference {rel:.3g}, parameters {p_rel:.3g} (tolerance 1e-9)")
    if a_worst != 0.0 or replays < 1 or b_bad \
            or not (rel <= 1e-9 and p_rel <= 1e-9):
        raise AssertionError(f"mesh: small model: diffs {diffs}, "
                             f"gradients {grads}, float64 card {l64} vs "
                             f"CPU {m64}")
    return {"f32_mesh_vs_plain_max_abs_diff": a_worst, "replays": replays,
            "step1_grads": grads, "f64_card_losses": l64,
            "f64_cpu_losses": m64, "f64_max_rel_diff": rel,
            "f64_param_max_rel_diff": p_rel}


def unsup_estimator(store, table, neg, dev, layout=None,
                    **cfg) -> BaseEstimator:
    """DeviceSampledUnsupervisedSage at the flagship's width (dim 128,
    fanouts [15, 10], 5 negatives, random weights from seed 0) in a
    plain BaseEstimator over the path's tables, Adam at lr 0.01."""
    model = DeviceSampledUnsupervisedSage(
        table.pad_row, FEAT_DIM, dim=DIM, fanouts=FANOUTS,
        num_negs=UNSUP_NEGS, uniform_sampling=table.uniform_rows,
        generator=torch.Generator().manual_seed(0))
    est = BaseEstimator(model, dict(learning_rate=TRAIN_LR, optimizer="adam",
                                    log_steps=1 << 30, checkpoint_steps=0,
                                    seed=0, **cfg), device=dev)
    est.static_batch.update({"feature_table": store.features,
                             "feature_scale": store.feature_scale,
                             **table.tables, **neg.tables})
    return with_layout(est, layout)


def phase_unsup(store, table, neg, graph, dev) -> dict:
    """Unsupervised GraphSAGE at full width on the flagship's tables,
    roots drawn over all nodes: K = 1 as phase 6 drives the flagship,
    K = 32 as phase 7 (bench.py's prefetch thread of depth 3), and the
    graph against eager steps at K = 8. gather_mean launches once per
    step; edges per step as the flagship's."""
    roots = root_input_fn(graph, BATCH, table.pad_row)
    r = {"k1": _drive_steps(unsup_estimator(store, table, neg, dev),
                            roots(), "unsup")}
    est = unsup_estimator(store, table, neg, dev, steps_per_loop=LOOP_K)
    it = make_feeder(roots(), workers=0, depth=FEEDER_DEPTH,
                     transform=lambda b: _on_card(b, est))
    try:
        r["k32"] = _drive_loop(est, it, LOOP_K, what="unsup loop")
    finally:
        it.close()
    del est
    r["graph_vs_eager"] = check_graph_vs_eager(
        lambda k: unsup_estimator(store, table, neg, dev, steps_per_loop=k),
        roots(), k=UNSUP_EQ_K,
        what="unsupervised GraphSAGE")
    return r


def skipgram_estimator(table, neg, dev, layout=None,
                       **cfg) -> BaseEstimator:
    """DeepWalk as bench.py --walk trains it (bench.py:392-503):
    DeviceSampledSkipGram, dim 128, walk_len 5, window 1/1, 5
    negatives, the unit-weight draw, Adam at lr 0.01, seed 0."""
    model = DeviceSampledSkipGram(
        table.pad_row, dim=DIM, walk_len=WALK_LEN, left_win=1, right_win=1,
        num_negs=WALK_NEGS, uniform_sampling=table.uniform_rows,
        generator=torch.Generator().manual_seed(0))
    est = BaseEstimator(model, dict(learning_rate=TRAIN_LR, optimizer="adam",
                                    log_steps=1 << 30, checkpoint_steps=0,
                                    seed=0, **cfg), device=dev)
    est.static_batch.update({**table.tables, **neg.tables})
    return with_layout(est, layout)


def phase_walk(table, neg, graph, dev) -> dict:
    """The DeepWalk skip-gram at bench.py --walk's shape and K = 8
    (bench.py's spl_walk, :814-818), fed by its prefetch thread (depth
    3); pairs/s/GPU = steps x 32768 x 10 / s, bench.py's metric. The
    path has no kernel of the port: gather_mean launches 0 times. Then
    the graph against eager steps at K = 8, and dense Adam's bytes
    beside the step's time: emb and ctx, [N+1, 128] float32 each, their
    dense gradients and two moments; Adam reads p, g, m, v and writes
    p, m, v."""
    pairs_per_root = len(gen_pair_offsets(WALK_LEN + 1, 1, 1))
    est = skipgram_estimator(table, neg, dev, steps_per_loop=WALK_K)
    roots = root_input_fn(graph, BATCH, table.pad_row)
    it = make_feeder(roots(), workers=0, depth=FEEDER_DEPTH,
                     transform=lambda b: _on_card(b, est))
    try:
        r = _drive_loop(est, it, WALK_K, what="walk", work="pairs",
                        work_per_step=BATCH * pairs_per_root,
                        kernels_per_step=0)
    finally:
        it.close()
    table_bytes = (table.pad_row + 1) * DIM * 4
    adam_bytes = 2 * 7 * table_bytes
    r["adam_bytes_per_step"] = adam_bytes
    r["adam_bound_ms"] = adam_bytes / HBM_BYTES_PER_S * 1e3
    step_ms = r["replay_ms_median"] / WALK_K
    log(f"walk: dense Adam over emb and ctx moves {adam_bytes / 1e9:.2f} GB "
        f"a step, {r['adam_bound_ms']:.3f} ms at {HBM_BYTES_PER_S / 1e12} "
        f"TB/s, against {step_ms:.3f} ms a step (events)")
    del est
    r["graph_vs_eager"] = check_graph_vs_eager(
        lambda k: skipgram_estimator(table, neg, dev, steps_per_loop=k),
        roots(), k=WALK_K, what="DeepWalk")
    return r


def probe_embedding_backward(table, dev) -> dict:
    """Whether F.embedding's dense backward on the card is deterministic
    (the graph-vs-eager checks compare bit for bit): the gradient of a
    [N+1, 128] table from the same upstream gradient, twice, for
    indices of the walk step's shape ([32768 x 10, 6] rows drawn over
    all nodes) and for the same count drawn from 1000 rows, where every
    row collects thousands of adds."""
    gen = torch.Generator(device=dev).manual_seed(0)
    n = table.pad_row + 1
    weight = torch.zeros((n, DIM), device=dev, requires_grad=True)
    shape = (BATCH * len(gen_pair_offsets(WALK_LEN + 1, 1, 1)),
             1 + WALK_NEGS)
    up = torch.randn(shape + (DIM,), generator=gen, device=dev)
    out = {}
    for name, hi in (("all rows", n), ("1000 rows", 1000)):
        idx = torch.randint(0, hi, shape, generator=gen, device=dev)
        grads = []
        for _ in range(2):
            g, = torch.autograd.grad(
                torch.nn.functional.embedding(idx, weight), weight, up)
            grads.append(g)
        out[name] = bool(torch.equal(grads[0], grads[1]))
    del weight, up, grads
    log("embedding backward: two runs bit for bit: " + ", ".join(
        f"{k}: {v}" for k, v in out.items()))
    return out


def _chi2_crit(df: int, z: float = CHI2_Z) -> float:
    """The chi-squared critical value at df degrees of freedom for the
    upper-tail probability of the normal deviate z (3.090: p = 0.001),
    by the Wilson-Hilferty cube approximation."""
    return df * (1 - 2 / (9 * df) + z * (2 / (9 * df)) ** 0.5) ** 3


def check_alias_draws(dev: torch.device) -> dict:
    """The alias draw on the card against the table's weights: a seeded
    table of ALIAS_ROWS rows x CAP slots (random weights, some zero, one
    dead row, one zero-degree row), each slot a distinct id so a pick
    names its column; ALIAS_DRAWS draws at count CAP (the row pick) and
    again at count 1 (the flat pick). Chi-squared over the live cells
    against w / sum(w) per row (df = cells - rows), p = 0.001; dead
    rows give only the pad. Then the card's picks against the CPU's for
    the same uniforms, bit for bit."""
    rng = np.random.default_rng(11)
    R, C = ALIAS_ROWS, CAP
    pad = R
    ids = (R + 1 + np.arange(R * C, dtype=np.int32)).reshape(R, C)
    w = rng.uniform(0.0, 4.0, (R, C)).astype(np.float32)
    w[rng.random((R, C)) < 0.1] = 0.0
    w[0] = 0.0                       # dead: ids kept, total weight 0
    nbr = np.full((R + 1, C), pad, np.int32)
    nbr[:R] = ids
    nbr[1] = pad                     # zero degree
    w[1] = 0.0
    cum = np.cumsum(np.concatenate([w, np.zeros((1, C), np.float32)]),
                    axis=1, dtype=np.float32)
    alias = build_alias_tables(nbr, cum_tab=cum)
    tabs = [torch.from_numpy(x).to(dev) for x in (nbr, cum, alias)]
    probs = w / np.maximum(w.sum(1, keepdims=True), 1e-30)
    out = {}
    gen = torch.Generator(device=dev).manual_seed(5)
    for count in (C, 1):
        n = ALIAS_DRAWS // count
        rows = torch.arange(n, device=dev, dtype=torch.int32) % R
        u = torch.rand((2, n, count), generator=gen, device=dev)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        picks = sample_hop(*tabs[:2], rows, count, uniforms=u,
                           alias_table=tabs[2])
        torch.cuda.synchronize()
        t_draw = time.monotonic() - t0
        got = picks.view(n, count)
        r = rows.long()[:, None].expand(n, count).reshape(-1)
        flat = got.reshape(-1).long()
        dead = (r == 0) | (r == 1)
        if not bool((flat[dead] == pad).all()):
            raise AssertionError("alias draw: a dead row gave a neighbor")
        live = flat[~dead] - (R + 1)
        if not bool(((live // C) == r[~dead]).all()):
            raise AssertionError("alias draw: a pick left its row")
        obs = torch.bincount(live, minlength=R * C).cpu().numpy().reshape(R, C)
        per_row = np.bincount(r[~dead].cpu().numpy(), minlength=R)
        exp = probs * per_row[:, None]
        cells = exp > 0
        if obs[~cells].any():
            raise AssertionError("alias draw: a zero-weight slot was drawn")
        stat = float(((obs[cells] - exp[cells]) ** 2 / exp[cells]).sum())
        df = int(cells.sum()) - int((per_row > 0).sum())
        crit = _chi2_crit(df)
        cpu = sample_hop(*(t.cpu() for t in tabs[:2]), rows.cpu(), count,
                         uniforms=u.cpu(), alias_table=tabs[2].cpu())
        same = bool(torch.equal(cpu, picks.cpu()))
        log(f"alias draws on the card: {n * count} at count {count} in "
            f"{t_draw * 1e3:.1f} ms; chi-squared {stat:.1f} at df {df} "
            f"(critical {crit:.1f} at p 0.001); picks equal to the CPU's "
            f"for the same uniforms: {same}")
        if not (stat <= crit and same):
            raise AssertionError(f"alias draw at count {count}: chi2 {stat} "
                                 f"> {crit} or card != CPU ({same})")
        out[f"count_{count}"] = {"draws": n * count, "chi2": stat, "df": df,
                                 "critical": crit, "draw_seconds": t_draw,
                                 "cpu_equal": same}
    return out


def phase_layouts(table, dev: torch.device) -> tuple:
    """The fused and alias layouts of the flagship's neighbor table,
    built on the host from its own [N+1, 32] tables (kept from phase 3,
    not built again): fuse_tables_host and build_alias_tables timed,
    uploaded, their bytes on the card; then the alias draw's checks.
    Returns (record, fused layout, alias layout) as static-batch
    tables."""
    nbr_h, cum_h = table.host_tables
    t0 = time.monotonic()
    fused = fuse_tables_host(nbr_h, cum_h)
    t_fuse = time.monotonic() - t0
    t0 = time.monotonic()
    alias = build_alias_tables(nbr_h, cum_tab=cum_h)
    t_alias = time.monotonic() - t0
    fused_dev = torch.from_numpy(fused).to(dev)
    del fused
    alias_dev = torch.from_numpy(alias).to(dev)
    del alias
    torch.cuda.synchronize()
    r = {"fuse_tables_host_seconds": t_fuse,
         "build_alias_tables_seconds": t_alias,
         "fused_bytes": fused_dev.numel() * 4,
         "alias_bytes": alias_dev.numel() * 4,
         "alias_draws": check_alias_draws(dev)}
    log(f"layouts: fuse_tables_host {t_fuse:.2f}s -> {r['fused_bytes']} "
        f"bytes on the card; build_alias_tables {t_alias:.2f}s -> "
        f"{r['alias_bytes']} bytes on the card ({table.pad_row + 1} x "
        f"{table.cap})")
    return (r, {"nbrcum_table": fused_dev},
            {**table.tables, "alias_table": alias_dev})


def phase_layout_flagship(store, table, graph, dev, layout,
                          what: str, against=None) -> dict:
    """The flagship at K = 32 over a layout's tables as phase 7 drives
    it (edges/s/GPU, ms a step, launches == steps), then the graph
    against eager steps at K = 32 (and, for the fused layout, against
    the split tables' weighted draw, bit for bit)."""
    est = flagship_estimator(store, table, graph, dev, layout=layout,
                             steps_per_loop=LOOP_K)
    it = make_feeder(est.train_input_fn(), workers=0, depth=FEEDER_DEPTH,
                     transform=lambda b: _on_card(b, est))
    try:
        r = _drive_loop(est, it, LOOP_K, what=f"{what} loop")
    finally:
        it.close()
    del est
    r["graph_vs_eager"] = check_graph_vs_eager(
        lambda k: flagship_estimator(store, table, graph, dev,
                                     layout=layout, steps_per_loop=k),
        flagship_estimator(store, table, graph, dev).train_input_fn(),
        what=f"{what} flagship", against=against)
    return r


def cache_estimator(store, table, graph, dev, mesh=None, **cfg):
    """DeviceSampledScalableSage at bench.py --act_cache's shape (dim
    128, one hop of 15, 2 layers, a bfloat16 cache over every table row,
    uniform sampling on the unit-weight table as bench.py's auto; random
    weights from seed 0) in a NodeEstimator with bench.py's training
    parameters."""
    model = DeviceSampledScalableSage(
        NUM_CLASSES, FEAT_DIM, multilabel=False, dim=DIM,
        fanout=CACHE_FANOUT, num_layers=CACHE_LAYERS,
        max_id=int(store.features.shape[0]) - 1,
        cache_dtype=torch.bfloat16, uniform_sampling=table.uniform_rows,
        generator=torch.Generator().manual_seed(0))
    return NodeEstimator(
        model, dict(batch_size=BATCH, learning_rate=TRAIN_LR,
                    optimizer="adam", log_steps=1 << 30, checkpoint_steps=0,
                    train_node_type=-1, seed=0, **cfg),
        graph, None, feature_store=store, device_sampler=table, device=dev,
        mesh=mesh)


def phase_act_cache(store, table, graph, dev) -> dict:
    """The activation cache at bench.py --act_cache's shape: K = 1 as
    phase 6 drives the flagship and K = 32 as phase 7, two gather_mean
    launches a step (layer 0's int8 feature rows, layer 1's bfloat16
    cache rows read as float32); nodes/s and edges/s with bench.py's
    2 x B x 15 edges a step; the graph against eager steps at K = 32,
    the caches included, bit for bit; then refresh_act_cache over every
    row in 8192-row chunks: seconds, launches (2 a chunk), the pad row
    zero and the rows it wrote."""
    r = {"k1": _drive_steps(cache_estimator(store, table, graph, dev),
                            cache_estimator(store, table, graph,
                                            dev).train_input_fn(),
                            "act cache", work_per_step=CACHE_EDGES_PER_STEP,
                            kernels_per_step=CACHE_LAYERS)}
    r["k1"]["nodes_per_s"] = r["k1"]["roots_per_s"]
    est = cache_estimator(store, table, graph, dev,
                          steps_per_loop=LOOP_K)
    it = make_feeder(est.train_input_fn(), workers=0, depth=FEEDER_DEPTH,
                     transform=lambda b: _on_card(b, est))
    try:
        r["k32"] = _drive_loop(est, it, LOOP_K, what="act cache loop",
                               work_per_step=CACHE_EDGES_PER_STEP,
                               kernels_per_step=CACHE_LAYERS)
    finally:
        it.close()
    r["k32"]["nodes_per_s"] = r["k32"]["roots_per_s"]
    chunks = -(-(int(store.features.shape[0]) - 1) // CACHE_CHUNK)
    torch.cuda.synchronize()
    gather_mean.launches = 0
    t0 = time.monotonic()
    refresh_act_cache(est, chunk=CACHE_CHUNK)
    torch.cuda.synchronize()
    t_refresh = time.monotonic() - t0
    launches = gather_mean.launches
    h = est.model.encoder.cache_1.h
    written = int((h.float().abs().sum(1) > 0).sum())
    if launches != CACHE_LAYERS * chunks or h[-1].any() \
            or not torch.isfinite(h.float()).all():
        raise AssertionError(f"refresh_act_cache: {launches} launches for "
                             f"{chunks} chunks, pad row {h[-1]}")
    r["refresh"] = {"seconds": t_refresh, "chunks": chunks,
                    "gather_mean_launches": launches, "rows_written": written,
                    "cache_bytes": h.numel() * h.element_size()}
    log(f"act cache: refresh_act_cache over {h.shape[0] - 1} rows in "
        f"{chunks} chunks of {CACHE_CHUNK}: {t_refresh:.2f}s, gather_mean "
        f"launches {launches}, rows written {written}, pad row zero; cache "
        f"{r['refresh']['cache_bytes']} bytes ({h.dtype})")
    r["kernel_vs_plain"] = cache_forward_vs_plain(est)
    del est, h
    r["graph_vs_eager"] = check_graph_vs_eager(
        lambda k: cache_estimator(store, table, graph, dev,
                                  steps_per_loop=k),
        cache_estimator(store, table, graph, dev).train_input_fn(),
        what="act cache")
    return r


def cache_forward_vs_plain(est) -> dict:
    """One eval forward of the activation-cache model over the refreshed
    caches, its two neighbor means (layer 0's int8 feature rows, layer
    1's bfloat16 cache rows) through the kernel and through
    gather_mean_reference, with the same sampled rows: the embeddings
    agree within 2^-7 of their largest magnitude (layer 0's mean is
    stored as bfloat16)."""
    from euler_tpu_torch.estimator.infer import eval_mode

    model = est.model
    batch = {**base_estimator._to_device(next(est.train_input_fn()),
                                         est.device), **est.static_batch}
    with eval_mode(model), torch.inference_mode():
        emb_k = model.embed(batch)
        emb_p = model.embed(batch, neighbor_mean=gather_mean_reference)
    _check_finite("act cache embedding", emb_k, (BATCH, DIM))
    err = max_abs_err(emb_k, emb_p)
    tol = 2 ** -7 * float(emb_p.abs().max())
    log(f"act cache: kernel vs plain forward over the refreshed caches: "
        f"err {err:.3g} (tol {tol:.3g})")
    if not err <= tol:
        raise AssertionError(f"act cache kernel forward vs plain forward: "
                             f"{err} > {tol}")
    return {"max_abs_err": err, "tol": tol}


def phase_alias_unsup(store, table, neg, alias, graph, dev) -> dict:
    """Unsupervised GraphSAGE and the DeepWalk skip-gram over the alias
    layout at K = 8 (bench.py --alias_sampler; the walk's p = q = 1
    steps take the alias draw): a few windows, the graph against eager
    steps, bit for bit."""
    roots = root_input_fn(graph, BATCH, table.pad_row)
    r = {
        "unsup": check_graph_vs_eager(
            lambda k: unsup_estimator(store, table, neg, dev, layout=alias,
                                      steps_per_loop=k),
            roots(), k=UNSUP_EQ_K,
            what="unsupervised GraphSAGE, alias"),
        "walk": check_graph_vs_eager(
            lambda k: skipgram_estimator(table, neg, dev, layout=alias,
                                         steps_per_loop=k),
            roots(), k=WALK_K,
            what="DeepWalk, alias")}
    # one gather_mean launch a step for the mean aggregator's deepest
    # hop; the skip-gram reads no feature table
    for name, want in (("unsup", UNSUP_EQ_K), ("walk", 0)):
        got = r[name]["gather_mean_launches_per_replay"]
        if got != want:
            raise AssertionError(f"{name} over the alias layout: {got} "
                                 f"gather_mean launches a replay, not {want}")
    return r


def _timed_method(obj, name: str, acc: dict, calls=None) -> None:
    """Shadow obj.name with a wrapper that adds its wall seconds to
    acc[name] (and one to calls[name], when given); `del obj.name`
    restores the method. Thread-safe enough for sums: the feeder's
    workers add under the GIL."""
    fn = getattr(obj, name)

    def timed(*a, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            acc[name] += time.perf_counter() - t0
            if calls is not None:
                calls[name] += 1

    setattr(obj, name, timed)


def hostfed_estimator(graph, flow, store, dev) -> NodeEstimator:
    """SupervisedGraphSage (dim 128, fanouts [15, 10], random weights
    from seed 0) in a NodeEstimator fed by the host flow, bench.py's
    training parameters (K = 1)."""
    model = SupervisedGraphSage(
        NUM_CLASSES, FEAT_DIM, multilabel=False, dim=DIM, fanouts=FANOUTS,
        generator=torch.Generator().manual_seed(0))
    return NodeEstimator(
        model, dict(batch_size=BATCH, learning_rate=TRAIN_LR,
                    optimizer="adam", log_steps=1 << 30, checkpoint_steps=0,
                    train_node_type=-1, seed=0),
        graph, flow, label_fid="label", label_dim=NUM_CLASSES,
        feature_store=store, device=dev)


def phase_hostfed(store, graph, dev) -> dict:
    """bench.py --host_sampler's path: the engine draws the roots and
    the [15, 10] fanout on the host (FanoutDataFlow, no features), the
    ids become rows of the int8 table (DeviceFeatureStore.lookup, the
    engine's row translation), SupervisedGraphSage trains on the card
    at K = 1: 2 warm-up and 5 timed steps; edges/s, ms a step, host ms
    a batch split into the root draw, sample_fanout and lookup, the
    card's busy share from one profiled step. The path takes no kernel
    of the port (a SageEncoder mean over host-sampled rows, as the
    reference's): gather_mean launches 0 times. Then one step of the
    host-arrays path (the engine's features as batch["layers"]) at the
    same shapes. Fails on a non-finite or non-falling loss, a skipped
    step or a launch."""
    est = hostfed_estimator(
        graph, FanoutDataFlow(graph, list(FANOUTS), with_features=False),
        store, dev)
    it = est.train_input_fn()
    gather_mean.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = est.train(it, max_steps=HOST_WARMUP)["losses"]
    acc = {"sample_node": 0.0, "sample_fanout": 0.0, "lookup": 0.0}
    for obj, name in ((graph, "sample_node"), (graph, "sample_fanout"),
                      (store, "lookup")):
        _timed_method(obj, name, acc)
    sums0 = _phase_sums(est)
    try:
        torch.cuda.synchronize()
        t0 = time.monotonic()
        res = est.train(it, max_steps=HOST_WARMUP + HOST_TIMED)
        torch.cuda.synchronize()
        timed_s = time.monotonic() - t0
    finally:
        for obj, name in ((graph, "sample_node"), (graph, "sample_fanout"),
                          (store, "lookup")):
            delattr(obj, name)
    input_wait_ms, dispatch_ms = (
        float(x) for x in np.subtract(_phase_sums(est), sums0))
    losses += res["losses"]
    launches = gather_mean.launches
    prof = profile_device(lambda: est._train_step(_on_card(next(it), est)),
                          "one host-fed step")
    if launches != 0:
        raise AssertionError(f"host-fed: gather_mean launched {launches} "
                             "times on a path that takes no kernel")
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise AssertionError(f"host-fed: loss not finite and falling: "
                             f"{losses}")
    if int(est.skipped_steps):
        raise AssertionError("host-fed: skipped steps")
    step_ms = timed_s * 1e3 / HOST_TIMED
    host = {k: v * 1e3 / HOST_TIMED for k, v in acc.items()}
    r = {"steps": est.step, "gather_mean_launches": launches,
         "losses": losses, "timed_seconds": timed_s,
         "edges_per_step": EDGES_PER_STEP,
         "edges_per_sec_per_gpu": EDGES_PER_STEP * HOST_TIMED / timed_s,
         "ms_per_step": step_ms, "host_ms_per_batch": host,
         "input_wait_ms_per_step": input_wait_ms / HOST_TIMED,
         "dispatch_ms_per_step": dispatch_ms / HOST_TIMED,
         "device_busy_share": prof["device_busy_ms"] / step_ms,
         "peak_device_bytes": torch.cuda.max_memory_allocated(),
         "profile": prof}
    log(f"host-fed: {HOST_TIMED} timed steps of {BATCH} roots, "
        f"{r['edges_per_sec_per_gpu']:.6g} edges/s/GPU, {step_ms:.1f} ms a "
        f"step; host ms a batch: sample_node {host['sample_node']:.1f}, "
        f"sample_fanout {host['sample_fanout']:.1f}, lookup "
        f"{host['lookup']:.1f} (input wait {r['input_wait_ms_per_step']:.1f}"
        f" ms a step, dispatch {r['dispatch_ms_per_step']:.1f}); device "
        f"busy {r['device_busy_share']:.1%} ({prof['device_busy_ms']:.2f} "
        f"ms a step); gather_mean launches {launches}; loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}")
    del est, it
    arrays = hostfed_estimator(
        graph, FanoutDataFlow(graph, list(FANOUTS), feature_ids=["feature"]),
        None, dev)
    t0 = time.monotonic()
    res = arrays.train(arrays.train_input_fn, max_steps=1)
    torch.cuda.synchronize()
    r["arrays_step_seconds"] = time.monotonic() - t0
    r["arrays_loss"] = res["loss"]
    if not np.isfinite(res["loss"]) or gather_mean.launches != 0:
        raise AssertionError(f"host-fed arrays step: loss {res['loss']}, "
                             f"{gather_mean.launches} launches")
    log(f"host-fed arrays: one step with the engine's features as layers "
        f"in {r['arrays_step_seconds']:.1f}s (batch built, copied and "
        f"stepped), loss {res['loss']:.4f}")
    return r


def _rss_bytes() -> int:
    """This process's resident set (VmRSS of /proc/self/status)."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    return 0


def _shard_meta(host: str, port: int) -> dict:
    """A shard's own node and edge counts, from its meta reply (the
    graph service's kMeta verb, msg type 1, in the classic frame that
    serving.wire speaks; rpc.cc:EncodeShardMeta's field order)."""
    with socket.create_connection((host, port), timeout=30) as sock:
        wire.write_frame(sock, 1, b"")
        _, body = wire.read_frame(sock)
    r = wire.Reader(body)
    out = {"shard_idx": r.u32(), "shard_num": r.u32(),
           "partition_num": r.u32()}
    r.array(np.float32, r.u32())           # node type weight sums
    r.array(np.float32, r.u32())           # edge type weight sums
    r.u64(), r.u64(), r.str_(), r.u32(), r.u32()
    out["nodes"], out["edges"] = r.u64(), r.u64()
    return out


def start_graph_service(graph) -> dict:
    """Phase 9l's set-up, on a thread of its own beside phases that
    leave the host idle: the engine dumped as 2 partitions under
    build/chip_smoke_cluster, a tcp: registry, and 2 shards loading
    their partitions side by side (ctypes releases the GIL)."""
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "build", "chip_smoke_cluster")
    state = {"dir": root, "registry": None, "shards": [None, None],
             "error": None, "nodes": graph.node_count,
             "edges": graph.edge_count}

    def run():
        try:
            shutil.rmtree(root, ignore_errors=True)
            state["rss_before"] = _rss_bytes()
            t0 = time.monotonic()
            graph.dump(root, num_partitions=2)
            state["dump_seconds"] = time.monotonic() - t0
            state["registry"] = gql.start_registry()
            state["spec"] = f"tcp:127.0.0.1:{state['registry'].port}"
            loads = [None, None]

            def load(i):
                t = time.monotonic()
                state["shards"][i] = gql.start_service(
                    root, shard_idx=i, shard_num=2,
                    registry_dir=state["spec"])
                loads[i] = time.monotonic() - t

            ts = [threading.Thread(target=load, args=(i,)) for i in (0, 1)]
            for t in ts:
                t.start()
            for t in ts:
                t.join()
            if None in state["shards"]:
                raise RuntimeError("a shard failed to start")
            state["load_seconds"] = loads
            state["setup_seconds"] = time.monotonic() - t0
            state["rss_after"] = _rss_bytes()
        except BaseException as e:  # re-raised by finish_graph_service
            state["error"] = e

    state["thread"] = threading.Thread(target=run, name="graph-service")
    state["thread"].start()
    return state


def stop_graph_service(state: dict) -> dict:
    """Stop the shards and the registry (each once), remove the dump;
    True where the port released a server (its handle zeroed, its port
    refusing connections) and the registry no longer answers."""
    state["thread"].join()
    ports = [s.port for s in state["shards"] if s is not None]
    for s in state["shards"]:
        if s is not None:
            s.stop()
    reg = state["registry"]
    if reg is not None:
        reg.stop()
    shutil.rmtree(state["dir"], ignore_errors=True)
    released = all(s is None or not s._h for s in state["shards"]) and (
        reg is None or not reg._h)
    for port in ports:
        with contextlib.suppress(OSError), socket.create_connection(
                ("127.0.0.1", port), timeout=2):
            released = False
    if reg is not None:
        try:
            gql.scan_registry(state["spec"])
            released = False
        except engine_lib.EngineError:
            pass
    return {"released": released, "rss_after_stop": _rss_bytes()}


def finish_graph_service(state: dict) -> dict:
    """Join the set-up; each shard's node and edge counts from its own
    meta, which must sum to the engine's."""
    state["thread"].join()
    if state["error"] is not None:
        raise state["error"]
    shards = gql.scan_registry(state["spec"])
    metas = [_shard_meta(h, p) for _, (h, p, _) in sorted(shards.items())]
    r = {k: state[k] for k in ("dump_seconds", "load_seconds",
                               "setup_seconds", "rss_before", "rss_after",
                               "nodes", "edges")}
    r["shards"] = metas
    nodes = sum(m["nodes"] for m in metas)
    edges = sum(m["edges"] for m in metas)
    log(f"graph service: dump {r['dump_seconds']:.1f}s, shard loads "
        f"{', '.join(f'{x:.1f}s' for x in r['load_seconds'])} (set-up "
        f"{r['setup_seconds']:.1f}s on its thread); RSS "
        f"{r['rss_before'] / 2**30:.2f} -> {r['rss_after'] / 2**30:.2f} GiB; "
        + "; ".join(f"shard {m['shard_idx']}: {m['nodes']} nodes, "
                    f"{m['edges']} edges" for m in metas))
    if len(metas) != 2 or (nodes, edges) != (r["nodes"], r["edges"]):
        raise AssertionError(
            f"graph service: shards hold {nodes} nodes and {edges} edges "
            f"({metas}); the engine {r['nodes']} and {r['edges']}")
    return r


def _same_bytes(what: str, a, b) -> None:
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype != b.dtype or a.shape != b.shape or \
            a.tobytes() != b.tobytes():
        raise AssertionError(f"graph service: {what} differs from the "
                             f"embedded engine's ({a.dtype}{a.shape} vs "
                             f"{b.dtype}{b.shape})")


def check_remote_reads(graph, remote, cached) -> dict:
    """On REMOTE_CHECK_IDS seeded ids: the remote engine's and the
    cache's (cold, then warm) full neighbor lists, dense features and
    node types equal the embedded engine's byte for byte; a remote
    [15, 10] fanout holds only true neighbors of each parent at the
    embedded shapes; the warm read is all hits, and a fetch during
    which the engine counts a degraded result inserts nothing."""
    all_ids = graph.all_node_ids()
    ids = np.random.default_rng(0).choice(all_ids, REMOTE_CHECK_IDS,
                                          replace=False)
    want_nb = graph.get_full_neighbor(ids)
    want_f = graph.get_dense_feature(ids, "feature")
    _same_bytes("node types", remote.get_node_type(ids),
                graph.get_node_type(ids))
    for what, eng in (("remote", remote), ("cache cold", cached),
                      ("cache warm", cached)):
        for a, b in zip(eng.get_full_neighbor(ids), want_nb, strict=True):
            _same_bytes(f"{what} full neighbors", a, b)
        _same_bytes(f"{what} features", eng.get_dense_feature(
            ids, "feature"), want_f)
    st = cached.cache_stats()
    if st["hits"] != 2 * REMOTE_CHECK_IDS or \
            st["misses"] != 2 * REMOTE_CHECK_IDS:
        raise AssertionError(f"graph service: the warm read is not all "
                             f"hits: {st}")
    # the poisoning guard: the engine counts a degraded result during
    # the fetch (feature getters never degrade; the wrapper makes one)
    inserts = st["inserts"]
    fetch = remote.get_dense_feature

    def degraded_fetch(*a, **kw):
        remote._note_degraded()
        return fetch(*a, **kw)

    remote.get_dense_feature = degraded_fetch
    try:
        fresh = np.setdiff1d(all_ids[:2 * REMOTE_CHECK_IDS], ids)[:64]
        cached.get_dense_feature(fresh, "feature")
    finally:
        del remote.get_dense_feature
    st = cached.cache_stats()
    if st["inserts"] != inserts or st["poison_skips"] != 1:
        raise AssertionError(f"graph service: a degraded fetch went into "
                             f"the cache: {st}")
    # remote draws run on the shards' threads: held by membership
    roots = ids
    hops, _, _ = remote.sample_fanout(roots, list(FANOUTS))
    shapes = [h.shape for h in hops]
    want = [(REMOTE_CHECK_IDS * FANOUTS[0],),
            (REMOTE_CHECK_IDS * FANOUTS[0] * FANOUTS[1],)]
    if shapes != want:
        raise AssertionError(f"graph service: fanout shapes {shapes}, not "
                             f"{want}")
    parents = [roots, hops[0]]
    if int(all_ids.max()) >= 1 << 32:  # the (parent, child) keys below
        raise AssertionError("graph service: node ids past 2^32")
    bad = 0
    for hop, par, k in zip(hops, parents, FANOUTS):
        uniq, inv = np.unique(par, return_inverse=True)
        off, nbr, _, _ = graph.get_full_neighbor(uniq)
        deg = np.diff(off.astype(np.int64))
        edge_key = (np.repeat(np.arange(uniq.size, dtype=np.uint64), deg)
                    << np.uint64(32)) | nbr
        pair_key = (np.repeat(inv.astype(np.uint64), k) << np.uint64(32)) \
            | hop
        ok = np.isin(pair_key, edge_key)
        # a parent without neighbors pads with the default id 0
        ok |= (np.repeat(deg[inv], k) == 0) & (hop == 0)
        bad += int((~ok).sum())
    if bad:
        raise AssertionError(f"graph service: {bad} sampled ids are not "
                             "neighbors of their parent")
    log(f"graph service: {REMOTE_CHECK_IDS} ids read remote, cached cold "
        f"and warm byte-equal to the embedded engine (neighbors, "
        f"features, types); a [15, 10] fanout of {sum(h.size for h in hops)}"
        f" ids all true neighbors; a fetch counted degraded (health()'s "
        f"degraded 1 below) cached nothing; cache {st}")
    return {"cache_after_checks": st, "fanout_ids": int(sum(
        h.size for h in hops))}


def graph_service_estimator(cached, store, dev, workers: int):
    """hostfed_estimator's model and parameters over the cluster:
    FanoutDataFlow(cached remote, [15, 10], no features), rows from
    the embedded engine's lookup, feeder_workers `workers`."""
    model = SupervisedGraphSage(
        NUM_CLASSES, FEAT_DIM, multilabel=False, dim=DIM, fanouts=FANOUTS,
        generator=torch.Generator().manual_seed(0))
    return NodeEstimator(
        model, dict(batch_size=BATCH, learning_rate=TRAIN_LR,
                    optimizer="adam", log_steps=1 << 30, checkpoint_steps=0,
                    train_node_type=-1, seed=0, feeder_workers=workers),
        cached, FanoutDataFlow(cached, list(FANOUTS), with_features=False),
        label_fid="label", label_dim=NUM_CLASSES, feature_store=store,
        device=dev)


def _train_from_cluster(cached, store, dev, workers: int) -> dict:
    """HOST_WARMUP + HOST_TIMED host-fed steps from the cluster at K = 1
    (workers > 1: the ParallelPrefetcher's workers build the batches
    over the pooled client); host ms a batch by call, averaged over the
    batches built; busy share from one profiled step."""
    est = graph_service_estimator(cached, store, dev, workers)
    src = est.train_input_fn if workers > 1 else est.train_input_fn()
    remote = cached._engine
    gather_mean.launches = 0
    health0 = remote.health()
    losses = est.train(src, max_steps=HOST_WARMUP)["losses"]
    names = (("sample_node", cached), ("sample_fanout", remote),
             ("lookup", store))
    acc = {n: 0.0 for n, _ in names}
    calls = {n: 0 for n, _ in names}
    for n, obj in names:
        _timed_method(obj, n, acc, calls)
    sums0 = _phase_sums(est)
    try:
        torch.cuda.synchronize()
        t0 = time.monotonic()
        res = est.train(src, max_steps=HOST_WARMUP + HOST_TIMED)
        torch.cuda.synchronize()
        timed_s = time.monotonic() - t0
    finally:
        for n, obj in names:
            delattr(obj, n)
    input_wait_ms, dispatch_ms = (
        float(x) for x in np.subtract(_phase_sums(est), sums0))
    losses += res["losses"]
    launches = gather_mean.launches
    it = est.train_input_fn()
    prof = profile_device(lambda: est._train_step(_on_card(next(it), est)),
                          f"one step from the cluster ({workers} workers)")
    health = remote.health()
    what = f"graph service, feeder_workers {workers}"
    if launches != 0:
        raise AssertionError(f"{what}: gather_mean launched {launches} "
                             "times on a path that takes no kernel")
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise AssertionError(f"{what}: loss not finite and falling: "
                             f"{losses}")
    if int(est.skipped_steps) or res.get("skipped_batches"):
        raise AssertionError(f"{what}: skipped steps or batches")
    if health["degraded"] != health0["degraded"]:
        raise AssertionError(f"{what}: degraded batches: {health}")
    step_ms = timed_s * 1e3 / HOST_TIMED
    host = {n: acc[n] * 1e3 / max(calls["sample_node"], 1) for n in acc}
    r = {"feeder_workers": workers, "steps": est.step,
         "gather_mean_launches": launches, "losses": losses,
         "timed_seconds": timed_s, "edges_per_step": EDGES_PER_STEP,
         "edges_per_sec_per_gpu": EDGES_PER_STEP * HOST_TIMED / timed_s,
         "ms_per_step": step_ms, "host_ms_per_batch": host,
         "batches_built": calls,
         "input_wait_ms_per_step": input_wait_ms / HOST_TIMED,
         "dispatch_ms_per_step": dispatch_ms / HOST_TIMED,
         "device_busy_share": prof["device_busy_ms"] / step_ms,
         "profile": prof, "health": health}
    log(f"{what}: {HOST_TIMED} timed steps of {BATCH} roots, "
        f"{r['edges_per_sec_per_gpu']:.6g} edges/s/GPU, {step_ms:.1f} ms a "
        f"step; host ms a batch ({calls['sample_node']} built): remote "
        f"sample_node {host['sample_node']:.1f}, remote sample_fanout "
        f"{host['sample_fanout']:.1f}, lookup {host['lookup']:.1f} (input "
        f"wait {r['input_wait_ms_per_step']:.1f} ms a step); device busy "
        f"{r['device_busy_share']:.1%} ({prof['device_busy_ms']:.2f} ms a "
        f"step); gather_mean launches {launches}; loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}")
    return r


def phase_graph_service(store, graph, state: dict, dev) -> dict:
    """Phase 9l: the flagship trained host-fed from a 2-shard cluster of
    its own graph, found through a tcp: registry (set-up joined here),
    after the reads and draws are checked against the embedded engine;
    then the engines, shards and registry stopped and released."""
    t0 = time.monotonic()
    r = {}
    remote = cached = None
    try:
        r["setup"] = finish_graph_service(state)
        r["setup_wait_seconds"] = time.monotonic() - t0
        remote = RemoteGraphEngine(state["spec"], pool_size=GRAPH_POOL)
        cached = CachedGraphEngine(remote)
        r["checks"] = check_remote_reads(graph, remote, cached)
        for workers in (0, *GRAPH_FEEDERS):
            r[f"feeders_{workers}"] = _train_from_cluster(cached, store,
                                                          dev, workers)
        r["rpc_transport_stats"] = rpc_transport_stats()
        r["health"] = cached.health()
        log(f"graph service: rpc {r['rpc_transport_stats']}; health "
            f"{r['health']}")
    finally:
        if cached is not None:
            cached.close()
        elif remote is not None:
            remote.close()
        r["teardown"] = stop_graph_service(state)
    if not r["teardown"]["released"]:
        raise AssertionError(f"graph service: not released: "
                             f"{r['teardown']}")
    r["seconds"] = time.monotonic() - t0
    log(f"graph service: {r['seconds']:.1f}s on the critical path "
        f"({r['setup_wait_seconds']:.1f}s waiting for the set-up); "
        f"stopped and released, RSS "
        f"{r['teardown']['rss_after_stop'] / 2**30:.2f} GiB")
    return r


def layerwise_estimator(store, table, graph, dev, layout=None, **cfg):
    """DeviceSampledLayerwiseGCN at bench.py --layerwise's shape (dim 128,
    pools (512, 512), random weights from seed 0) in a NodeEstimator
    over the path's tables (or a layout's) with bench.py's training
    parameters (batch 512, Adam lr 0.01, roots over every node)."""
    model = DeviceSampledLayerwiseGCN(
        NUM_CLASSES, FEAT_DIM, multilabel=False, dim=DIM,
        layer_sizes=LW_SIZES, generator=torch.Generator().manual_seed(0))
    return with_layout(NodeEstimator(
        model, dict(batch_size=LW_BATCH, learning_rate=TRAIN_LR,
                    optimizer="adam", log_steps=1 << 30, checkpoint_steps=0,
                    train_node_type=-1, seed=0, **cfg),
        graph, None, feature_store=store, device_sampler=table,
        device=dev), layout)


def adjacency_share(est, it, step_ms: float, busy_ms: float) -> dict:
    """What the dense adjacency build costs a step: dense_adjacency for
    both layers of one batch's draw (CUDA events), its share of the
    event-timed step and of the profiled step's device time (busy_ms),
    and the device memory it allocates at its peak (the [n, C, n']
    comparison and its weighted copy); beside it the whole draw (pools
    and adjacencies)."""
    batch = {**_on_card(next(it), est), **est.static_batch}
    with torch.no_grad():
        levels, _ = est.model.sample_levels(batch)
        args = []
        for lv, nxt in zip(levels[:-1], levels[1:]):
            rows = lv.long()
            args.append((batch["nbr_table"][rows],
                         slot_weights(batch["cum_table"][rows]), lv, nxt))
        ms = time_ms(lambda: [dense_adjacency(*a) for a in args])
        draw_ms = time_ms(lambda: est.model.sample_levels(batch))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        for a in args:
            dense_adjacency(*a)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
    elems = sum(a[0].numel() * a[3].numel() for a in args)
    r = {"adjacency_ms": ms, "draw_ms": draw_ms, "step_ms": step_ms,
         "step_share": ms / step_ms, "draw_share": draw_ms / step_ms,
         "busy_ms": busy_ms,
         # a profiler that records no device time is reported, not failed
         "busy_share": ms / busy_ms if busy_ms > 0 else float("nan"),
         "draw_busy_share": draw_ms / busy_ms if busy_ms > 0
         else float("nan"),
         "hit_elements": elems, "peak_bytes": peak}
    log(f"layerwise adjacency: dense_adjacency of both layers "
        f"{ms:.4f} ms ({r['step_share']:.1%} of the {step_ms:.3f} ms "
        f"step, {r['busy_share']:.1%} of its {busy_ms:.3f} ms of device "
        f"time), the whole draw {draw_ms:.4f} ms ({r['draw_share']:.1%}, "
        f"{r['draw_busy_share']:.1%}); {elems} comparison elements, peak "
        f"{peak / 2**20:.1f} MiB allocated by the build")
    return r


def phase_layerwise(store, table, graph, alias, dev) -> dict:
    """bench.py --layerwise on the phase-3 tables: K = 1 as phase 6
    drives the flagship and K = 32 (2 timed windows) as phase 7, both fed
    by the prefetch thread; pool-nodes/s (bench.py's
    layerwise_train_pool_nodes_per_sec_per_chip, (batch + sum(pools))
    x steps / s), ms a step, host ms a step, busy share, peak memory, a
    finite falling loss, no gather_mean launch (the model gathers whole
    feature rows); the adjacency build's share of a step; the graph
    against eager steps at K = 32, bit for bit; then the same K = 32
    timing and check over phase 9a's alias table (bench.py
    --alias_sampler --layerwise)."""
    r = {}
    est = layerwise_estimator(store, table, graph, dev)
    it = make_feeder(est.train_input_fn(), workers=0, depth=FEEDER_DEPTH,
                     transform=lambda b: _on_card(b, est))
    try:
        r["k1"] = _drive_steps(est, it, "layerwise", work="pool_nodes",
                               work_per_step=LW_NODES_PER_STEP,
                               kernels_per_step=0, batch=LW_BATCH)
        r["adjacency"] = adjacency_share(
            est, it, r["k1"]["step_ms_median"],
            r["k1"]["profile"]["device_busy_ms"])
    finally:
        it.close()
    del est
    for name, layout in (("split", None), ("alias", alias)):
        est = layerwise_estimator(store, table, graph, dev, layout=layout,
                                  steps_per_loop=LOOP_K)
        it = make_feeder(est.train_input_fn(), workers=0,
                         depth=FEEDER_DEPTH,
                         transform=lambda b, e=est: _on_card(b, e))
        try:
            r[f"k32_{name}"] = _drive_loop(
                est, it, LOOP_K, what=f"layerwise loop, {name}",
                work="pool_nodes", work_per_step=LW_NODES_PER_STEP,
                kernels_per_step=0, batch=LW_BATCH, n_windows=LW_WINDOWS)
        finally:
            it.close()
        del est
        r[f"graph_vs_eager_{name}"] = check_graph_vs_eager(
            lambda k, lay=layout: layerwise_estimator(
                store, table, graph, dev, layout=lay, steps_per_loop=k),
            layerwise_estimator(store, table, graph, dev).train_input_fn(),
            what=f"layerwise, {name}")
    launches = [r["k1"]["gather_mean_launches"],
                r["k32_split"]["gather_mean_device_launches"],
                r["k32_alias"]["gather_mean_device_launches"]]
    log(f"layerwise: gather_mean launches {launches} (K = 1, K = 32 split, "
        f"K = 32 alias): the model reads whole feature rows")
    return r


def _mp_step_grads(model, raw, dev):
    """One eval-mode forward (no dropout) and backward of a model on a
    host batch: (loss, {name: gradient on the host})."""
    model = model.to(dev).eval()
    model.zero_grad(set_to_none=True)
    out = model(base_estimator._to_device(raw, dev))
    out.loss.backward()
    return float(out.loss.detach()), {k: p.grad.detach().cpu()
                             for k, p in model.named_parameters()}


def check_mp_repeats(make_estimator, what: str, steps: int = 3) -> bool:
    """Two trainings of `steps` steps from the same weights, engine seed
    and dropout stream on the card: the same losses and parameters, bit
    for bit (mp_ops' sums on CUDA are sorted segment sums, not
    atomics). make_estimator() gives an estimator, or (estimator,
    input_fn) for one without train_input_fn."""
    runs = []
    for _ in range(2):
        est = make_estimator()
        est, input_fn = est if isinstance(est, tuple) else (
            est, est.train_input_fn)
        seed_engine(1)
        res = est.train(input_fn, max_steps=steps)
        runs.append((res["losses"], est.model.state_dict()))
    (la, sa), (lb, sb) = runs
    same = la == lb and all(torch.equal(v, sb[k]) for k, v in sa.items())
    log(f"{what}: {steps} steps twice from the same weights and draws: "
        f"bit for bit {same}")
    if not same:
        raise AssertionError(f"{what}: two runs of the same steps differ: "
                             f"losses {la} vs {lb}")
    return same


def phase_fullbatch(dev) -> dict:
    """Full-batch message passing on the pubmed stand-in through
    FullBatchDataFlow (the whole graph and its 500-dim features in every
    batch, copied to the card each step as the reference's
    _to_device_tree copies it): for the runners' GCN and GAT (8 heads)
    models, one step's loss and gradients on the card against the CPU
    from the same weights and batch (eval mode: the card's and the CPU's
    dropout bits differ): the loss within rtol 1e-4, the gradients
    within 1e-5 of the largest (the card's segment sums add in another
    order); 3 steps twice on the card, bit for bit (check_mp_repeats);
    then MP_TIMED timed steps at the runner's
    defaults: ms a step, the host's batch build and the host-to-device
    copy a step and their shares, the busy share of one profiled step,
    a finite loss, no skipped step and no gather_mean launch."""
    data = get_dataset(MP_DATASET)
    g = data.engine
    flow = full_batch_flow(data)
    cpu = torch.device("cpu")
    out = {}
    for conv, cfg in MP_MODELS.items():
        def model():
            return ConvModel(data.num_classes, data.feature_dim, conv,
                             dim=cfg["dim"], conv_kwargs=cfg["kw"],
                             dropout=cfg["dropout"],
                             generator=torch.Generator().manual_seed(0))
        seed_engine(0)
        roots = g.sample_node(MP_BATCH, 0)
        raw = {**flow(roots), "labels": g.get_dense_feature(
            roots, "label", data.num_classes)}
        (lc, gc), (lp, gp) = (_mp_step_grads(model(), raw, d)
                              for d in (dev, cpu))
        gerr = max(max_abs_err(gc[k], v) / max(float(v.abs().max()), 1e-30)
                   for k, v in gp.items())
        lerr = abs(lc - lp) / abs(lp)
        log(f"fullbatch {conv}: card vs CPU on one {MP_DATASET} batch: loss "
            f"{lc:.6f} vs {lp:.6f} (rel {lerr:.3g}, tol 1e-4), gradients "
            f"max err {gerr:.3g} of the largest (tol 1e-5)")
        if not (lerr <= 1e-4 and gerr <= 1e-5):
            raise AssertionError(f"fullbatch {conv}: the card disagrees "
                                 "with the CPU")

        def estimator():
            return NodeEstimator(
                model(), dict(batch_size=MP_BATCH, learning_rate=cfg["lr"],
                              weight_decay=cfg["wd"], log_steps=1 << 30,
                              checkpoint_steps=0, seed=0),
                g, flow, label_fid="label", label_dim=data.num_classes,
                device=dev)
        repeat = check_mp_repeats(estimator, f"fullbatch {conv}")
        est = estimator()
        it = est.train_input_fn()
        gather_mean.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses = est.train(it, max_steps=MP_WARMUP)["losses"]
        build_ms, copy_ms = [], []
        for _ in range(5):
            t0 = time.perf_counter()
            b = next(it)
            t1 = time.perf_counter()
            _on_card(b, est)
            torch.cuda.synchronize()
            build_ms.append((t1 - t0) * 1e3)
            copy_ms.append((time.perf_counter() - t1) * 1e3)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        res = est.train(it, max_steps=MP_WARMUP + MP_TIMED)
        torch.cuda.synchronize()
        step_ms = (time.monotonic() - t0) * 1e3 / MP_TIMED
        losses += res["losses"]
        prof = profile_device(lambda: est._train_step(_on_card(next(it),
                                                               est)),
                              f"one full-batch {conv} step on "
                              f"{MP_DATASET}")
        if not np.isfinite(losses).all() or res["skipped_steps"] \
                or gather_mean.launches:
            raise AssertionError(f"fullbatch {conv}: losses {losses}, "
                                 f"{res['skipped_steps']} skipped, "
                                 f"{gather_mean.launches} launches")
        b_ms, c_ms = statistics.median(build_ms), statistics.median(copy_ms)
        x_bytes = int(np.asarray(raw["x"]).nbytes)
        out[conv] = {
            "loss_rel_err": lerr, "grad_err": gerr, "losses": losses,
            "ms_per_step": step_ms, "host_build_ms": b_ms,
            "host_to_device_ms": c_ms, "host_to_device_share": c_ms / step_ms,
            "host_build_share": b_ms / step_ms,
            "device_busy_ms": prof["device_busy_ms"],
            "device_busy_share": prof["device_busy_ms"] / step_ms,
            "x_bytes": x_bytes, "repeats_bit_for_bit": repeat,
            "peak_device_bytes": torch.cuda.max_memory_allocated(),
            "gather_mean_launches": gather_mean.launches, "profile": prof}
        log(f"fullbatch {conv}: {MP_TIMED} steps on {MP_DATASET} "
            f"({g.node_count} nodes, x {x_bytes} bytes a batch): "
            f"{step_ms:.2f} ms a step; host batch build {b_ms:.2f} ms "
            f"({b_ms / step_ms:.1%}), host-to-device copy {c_ms:.2f} ms "
            f"({c_ms / step_ms:.1%}); device busy "
            f"{prof['device_busy_ms']:.3f} ms a step "
            f"({prof['device_busy_ms'] / step_ms:.1%}); loss "
            f"{losses[0]:.4f} -> {losses[-1]:.4f}; gather_mean launches "
            f"{gather_mean.launches}")
        del est, it
    return out


def _pin_prelu_kinks(model, masks: list, flips: list) -> list:
    """Forward hooks on the model's PReLU modules. With `masks` empty
    each call records its input's sign pattern (x >= 0) into it; else
    each call takes the next recorded pattern in place of its own and
    appends to `flips` how many of its inputs' signs differ from it.
    Returns the hook handles."""
    recording = not masks
    queue = list(masks)

    def hook(mod, args, out):
        x = args[0]
        if recording:
            masks.append((x >= 0).cpu())
            return None
        mask = queue.pop(0).to(x.device)
        flips.append(int(((x >= 0) != mask).sum()))
        return torch.where(mask, x, mod.negative_slope.to(x.dtype) * x)

    return [m.register_forward_hook(hook) for m in model.modules()
            if isinstance(m, PReLU)]


def _card_vs_cpu(what: str, make_model, raw: dict, dev) -> tuple:
    """One eval-mode step of make_model() on the CPU, then on the card:
    (loss relative error, the largest gradient error over the largest
    gradient, the parameter where it is, PReLU inputs whose sign the
    card saw otherwise); logged. A PReLU input within the devices'
    rounding of 0 can take the other side of the kink on the card, and
    one such flip moves a gradient by far more than rounding does (DGI
    at dim 512 has 2.8M PReLU inputs, several of them within 1e-6 of
    the largest of 0; on an H100 one flip moved a weight's gradient by
    5.7e-4 of the largest). So the card's PReLUs take the CPU's sign
    pattern, and the flips are counted: both devices then differentiate
    the same piece of the function."""
    cpu = torch.device("cpu")
    masks, flips = [], []
    model = make_model(cpu)
    hooks = _pin_prelu_kinks(model, masks, flips)
    lp, gp = _mp_step_grads(model, raw, cpu)
    model = make_model(dev)
    hooks += _pin_prelu_kinks(model, masks, flips)
    lc, gc = _mp_step_grads(model, raw, dev)
    for h in hooks:
        h.remove()
    top = max(float(v.abs().max()) for v in gp.values())
    errs = {k: max_abs_err(gc[k], v) / max(top, 1e-30)
            for k, v in gp.items()}
    worst = max(errs, key=errs.get)
    lerr = abs(lc - lp) / abs(lp)
    log(f"zoo {what}: card vs CPU on one batch: loss {lc:.6f} vs {lp:.6f} "
        f"(rel {lerr:.3g}, tol 1e-4), gradients max err {errs[worst]:.3g} "
        f"of the largest (tol 1e-5, at {worst})"
        + (f"; PReLU inputs on the other side of the kink on the card: "
           f"{sum(flips)} of {sum(m.numel() for m in masks)}"
           if masks else ""))
    return lerr, errs[worst], worst, sum(flips)


def _zoo_case(what: str, make_est, raw: dict, dev,
              input_fn=None, launches_per_step: int = 0,
              compare=None) -> dict:
    """One model of phases 9i and 9j: one step's loss and gradients on
    the card against the CPU from the same weights and host batch (eval
    mode, as 9h; _card_vs_cpu, or compare() when given), then
    ZOO_WARMUP + ZOO_TIMED steps on the card through its estimator
    (input_fn, default its train_input_fn): ms a step, the host's batch
    build a step and its share, the busy share of one profiled step, a
    finite loss, no skipped step and launches_per_step gather_mean
    launches a step (the count set to 0 just before the steps)."""
    lerr, gerr, worst, flips = (compare() if compare is not None else
                                _card_vs_cpu(what,
                                             lambda d: make_est(d).model,
                                             raw, dev))
    if not (lerr <= 1e-4 and gerr <= 1e-5):
        raise AssertionError(f"zoo {what}: the card disagrees with the CPU")
    est = make_est(dev)
    est.log_steps, est.ckpt_steps = 1 << 30, 0
    it = (input_fn or est.train_input_fn)()
    gather_mean.launches = 0
    torch.cuda.synchronize()
    losses = est.train(it, max_steps=ZOO_WARMUP)["losses"]
    build_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        next(it)
        build_ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    res = est.train(it, max_steps=ZOO_WARMUP + ZOO_TIMED)
    torch.cuda.synchronize()
    step_ms = (time.monotonic() - t0) * 1e3 / ZOO_TIMED
    launches = gather_mean.launches
    losses += res["losses"]
    prof = profile_device(lambda: est._train_step(_on_card(next(it), est)),
                          f"one {what} step")
    if not np.isfinite(losses).all() or res["skipped_steps"] \
            or launches != launches_per_step * (ZOO_WARMUP + ZOO_TIMED):
        raise AssertionError(f"zoo {what}: losses {losses}, "
                             f"{res['skipped_steps']} skipped, "
                             f"{launches} launches in "
                             f"{ZOO_WARMUP + ZOO_TIMED} steps")
    b_ms = statistics.median(build_ms)
    log(f"zoo {what}: {ZOO_TIMED} steps: {step_ms:.3f} ms a step; host "
        f"batch build {b_ms:.3f} ms ({b_ms / step_ms:.1%}); device busy "
        f"{prof['device_busy_ms']:.3f} ms a step "
        f"({prof['device_busy_ms'] / step_ms:.1%}); loss {losses[0]:.4f} "
        f"-> {losses[-1]:.4f}; gather_mean launches {launches} in "
        f"{ZOO_WARMUP + ZOO_TIMED} steps")
    return {"loss_rel_err": lerr, "grad_err": gerr, "grad_err_at": worst,
            "prelu_kink_flips": flips, "losses": losses,
            "ms_per_step": step_ms, "host_build_ms": b_ms,
            "host_build_share": b_ms / step_ms,
            "device_busy_ms": prof["device_busy_ms"],
            "device_busy_share": prof["device_busy_ms"] / step_ms,
            "gather_mean_launches": launches,
            "steps": ZOO_WARMUP + ZOO_TIMED, "profile": prof}


def phase_zoo(dev) -> dict:
    """Slice 10 at the runners' default widths on one card: the four
    mutag runners' GraphModels (GraphEstimator, 16 graphs a batch), GAE
    and VGAE (FullBatchDataFlow on cora, 128 positive and 128 negative
    pairs; VGAE with a fixed ε), DGI (dim 512, cora's whole graph in the
    static batch, one corruption a step) and LGCN (host FanoutDataFlow,
    fanout 30, k 8): each through _zoo_case; then run_gin's dropout
    steps twice, bit for bit."""
    cpu = torch.device("cpu")
    out = {}
    mutag = get_dataset("mutag")
    for name, (conv, pool, defaults) in GRAPH_MODELS.items():
        args = graph_common.graph_argparser(**defaults).parse_args([])

        def make(d, conv=conv, pool=pool, args=args):
            return graph_common.graph_estimator(conv, pool, args, mutag, d)
        out[name] = _zoo_case(f"{name} mutag ({conv} + {pool}, dim "
                              f"{args.hidden_dim}, {args.num_layers} "
                              f"layers)", make,
                              next(make(cpu).train_input_fn()), dev)
    with common.shared_graphs():
        cora = common.load_graph("cora", 0)
        for variational in (False, True):
            args = run_gae.build_parser().parse_args(
                ["--variational"] if variational else [])

            def make(d, args=args):
                return run_gae.gae_estimator(args, cora, d)
            seed_engine(0)
            raw = next(make(cpu).train_input_fn())
            if variational:
                raw["eps"] = np.random.default_rng(0).normal(
                    size=(raw["x"].shape[0], args.dim)).astype(np.float32)
            out["vgae" if variational else "gae"] = _zoo_case(
                f"{'vgae (a fixed eps)' if variational else 'gae'} cora",
                make, raw, dev)
        args = run_dgi.build_parser().parse_args([])
        est, full, input_fn = run_dgi.dgi_estimator(args, cora, cpu)
        raw = {**full, **next(input_fn())}
        del est
        out["dgi"] = _zoo_case(
            f"dgi cora (dim {args.dim})",
            lambda d: run_dgi.dgi_estimator(args, cora, d)[0], raw, dev,
            input_fn=input_fn)
        args = run_lgcn.parse_args([])
        seed_engine(0)
        raw = next(run_lgcn.lgcn_estimator(args, cora, cpu)
                   .train_input_fn())
        out["lgcn"] = _zoo_case(
            f"lgcn cora (fanout {args.fanout}, k {args.k})",
            lambda d: run_lgcn.lgcn_estimator(args, cora, d), raw, dev)
    args = graph_common.graph_argparser().parse_args(["--seed", "1"])
    out["gin_repeats_bit_for_bit"] = check_mp_repeats(
        lambda: graph_common.graph_estimator("gin", "sum", args, mutag, dev),
        f"zoo gin (dropout {args.dropout})", ZOO_REPEAT_STEPS)
    return out


class _TypedFlow:
    """A whole-graph flow whose batches carry S11_RELATIONS synthetic
    relations: edge_type = the edge's source row mod S11_RELATIONS, and
    group_edge_index = the edges of even and of odd type (GroupGNNNet's
    two groups)."""

    def __init__(self, flow):
        self.flow = flow
        self._extra = None

    def __call__(self, roots):
        batch = self.flow(roots)
        if self._extra is None:
            ei = batch["edge_index"]
            et = (ei[0] % S11_RELATIONS).astype(np.int32)
            self._extra = {"edge_type": et, "group_edge_index": [
                np.ascontiguousarray(ei[:, et % 2 == g]) for g in (0, 1)]}
        return {**batch, **self._extra}


class _GroupModel(SuperviseModel):
    """GroupGNNNet ("gnn", two groups of two GCN layers of width 32) and
    the dense head."""

    def __init__(self, num_classes, in_dim, generator=None):
        gnn = GroupGNNNet(in_dim, "gcn", 32, 2, 2, generator=generator)
        super().__init__(num_classes, False, gnn.out_dim,
                         generator=generator)
        self.gnn = gnn

    def embed(self, batch):
        return self.gnn(batch)


def _scalable_card_vs_cpu(make_est, raws: list, dev) -> tuple:
    """ScalableGraphSage on the CPU and on the card from the same
    weights: one training step on raws[0] each (an Adam step and the
    cache write), their caches compared (within 1e-5 of the largest
    value); then the card's model takes the CPU's parameters and caches
    (an Adam step turns a gradient near 0 into a step of +-lr on either
    side, so the two steps' weights are no common start) and both run
    one training-mode forward and backward on raws[1], which reads the
    rows the first step wrote: (loss relative error, the largest
    gradient error over the largest gradient, its parameter, 0),
    logged."""
    cpu = torch.device("cpu")
    models, caches = [], []
    for d in (cpu, dev):
        est = make_est(d)
        est.ckpt_steps = 0
        est.train(iter([raws[0]]), max_steps=1)
        caches.append(est.model.encoder.cache_1.h.detach().cpu().clone())
        models.append((est.model, d, est.max_id))
    cerr = max_abs_err(caches[1], caches[0]) / max(
        float(caches[0].abs().max()), 1e-30)
    models[1][0].load_state_dict(models[0][0].state_dict())
    out = []
    for model, d, max_id in models:
        model.train()
        model.zero_grad(set_to_none=True)
        res = model(base_estimator._to_device(raws[1], d, max_id))
        res.loss.backward()
        out.append((float(res.loss.detach()),
                    {k: p.grad.detach().cpu()
                     for k, p in model.named_parameters()}))
    (lp, gp), (lc, gc_) = out
    top = max(float(v.abs().max()) for v in gp.values())
    errs = {k: max_abs_err(gc_[k], v) / max(top, 1e-30)
            for k, v in gp.items()}
    worst = max(errs, key=errs.get)
    lerr = abs(lc - lp) / abs(lp)
    log(f"zoo scalable_sage: the cache after one training step on the "
        f"card within {cerr:.3g} of its largest value (tol 1e-5); card vs "
        f"CPU on the next step from the CPU's weights and cache: loss "
        f"{lc:.6f} vs {lp:.6f} (rel {lerr:.3g}, tol 1e-4), gradients max "
        f"err {errs[worst]:.3g} of the largest (tol 1e-5, at {worst})")
    if not cerr <= 1e-5:
        raise AssertionError("scalable_sage: the card's cache disagrees")
    return lerr, errs[worst], worst, 0


def phase_slice11(dev) -> dict:
    """Slice 11 at the runners' default widths on one card (phase 9j):
    each model through _zoo_case (card vs CPU, 20 timed steps); the
    host-fed ScalableGraphSage launches gather_mean once a step (its
    layer-1 cache read, a float32 cache [2708, 32] at n 64, k 10) and
    is compared after a first training step; then TransE's and the
    R-GCN runner's steps twice, bit for bit."""
    cpu = torch.device("cpu")
    out = {}
    with common.shared_graphs():
        cora = common.load_graph("cora", 0)
        args = run_geniepath.parse_args([])

        def make(d, args=args):
            return run_geniepath.build_estimator(args, cora, d)
        seed_engine(0)
        raw = next(make(cpu).train_input_fn())
        out["geniepath"] = _zoo_case(
            f"geniepath cora host-fed (fanouts {args.fanouts}, dim "
            f"{args.hidden_dim})", make, raw, dev)
        args = run_scalable_sage.build_parser().parse_args([])

        def make(d, args=args):
            return run_scalable_sage.build_estimator(args, cora, d)
        seed_engine(0)
        it = make(cpu).train_input_fn()
        raws = [next(it), next(it)]
        out["scalable_sage"] = _zoo_case(
            f"scalable_sage cora host-fed (one hop of {args.fanout}, dim "
            f"{args.hidden_dim}, f32 cache)", make, raws[0], dev,
            launches_per_step=args.num_layers - 1,
            compare=lambda: _scalable_card_vs_cpu(make, raws, dev))
        for mode, logits in (("supervise", "dot"), ("unsupervise", "dot"),
                             ("unsupervise", "cosine")):
            args = run_solution.build_parser().parse_args(
                ["--mode", mode, "--logits", logits])

            def make(d, args=args):
                return run_solution.build_estimator(args, cora, d)[0]
            seed_engine(0)
            _, sol = run_solution.build_estimator(args, cora, cpu)
            raw = next(sol.input_fn())
            name = f"solution {mode}" + (f" ({logits})"
                                         if mode == "unsupervise" else "")
            out[name] = _zoo_case(
                f"{name} cora (fanouts {args.fanouts}, dim {args.dim})",
                make, raw, dev, input_fn=sol.input_fn)
        flow = _TypedFlow(full_batch_flow(cora))
        for name, make_model in (
                ("relation", lambda g: ConvModel(
                    cora.num_classes, cora.feature_dim, "relation", dim=32,
                    conv_kwargs={"num_relations": S11_RELATIONS},
                    generator=g)),
                ("group", lambda g: _GroupModel(
                    cora.num_classes, cora.feature_dim, generator=g))):
            def make(d, make_model=make_model):
                return NodeEstimator(
                    make_model(torch.Generator().manual_seed(0)),
                    dict(batch_size=128, learning_rate=0.01),
                    cora.engine, flow, label_fid="label",
                    label_dim=cora.num_classes, device=d)
            seed_engine(0)
            raw = next(make(cpu).train_input_fn())
            out[name] = _zoo_case(
                f"{'RelationConv in BaseGNNNet' if name == 'relation' else 'GroupGNNNet (GCN)'} "
                f"cora, {S11_RELATIONS} synthetic relations", make, raw,
                dev)
    kg = get_dataset("fb15k237")
    for model in S11_KG_MODELS:
        args = run_transx.build_parser(model).parse_args([])

        def make(d, args=args):
            return run_transx.kg_estimator(args, kg, d)[0]
        seed_engine(0)
        est, input_fn = run_transx.kg_estimator(args, kg, cpu)
        raw = next(input_fn())
        out[model] = _zoo_case(
            f"{model} fb15k237 (dim {args.dim}, batch {args.batch_size}, "
            f"{args.num_negs} negatives)", make, raw, dev,
            input_fn=run_transx.kg_estimator(args, kg, cpu)[1])
    args = run_rgcn.build_parser().parse_args([])

    def make(d):
        return run_rgcn.rgcn_estimator(args, kg, d)[0]
    seed_engine(0)
    raw = next(run_rgcn.rgcn_estimator(args, kg, cpu)[1]())
    out["rgcn"] = _zoo_case(
        f"rgcn fb15k237 (dim {args.dim}, {args.num_rel_sample} relations x "
        f"fanout {args.fanout})", make, raw, dev,
        input_fn=run_rgcn.rgcn_estimator(args, kg, cpu)[1])
    targs = run_transx.build_parser().parse_args([])
    out["transe_repeats_bit_for_bit"] = check_mp_repeats(
        lambda: run_transx.kg_estimator(targs, kg, dev), "zoo TransE",
        ZOO_REPEAT_STEPS)
    out["rgcn_repeats_bit_for_bit"] = check_mp_repeats(
        lambda: run_rgcn.rgcn_estimator(args, kg, dev), "zoo rgcn",
        ZOO_REPEAT_STEPS)
    return out


# -- phase 9k: graphs that change ------------------------------------------

def _stream_counts() -> dict:
    """The streaming and alias-row counters of the obs registry."""
    reg = obs.default_registry()
    return {k: reg.counter(k).value for k in (
        "streaming_deltas_total", "streaming_exports_total",
        "streaming_swaps_total", "alias_rows_patched_total")}


def _dirty_rows(graph, dirty_ids) -> np.ndarray:
    """The engine rows of a delta's dirty ids, unique and ascending (ids
    the engine does not hold dropped)."""
    rows = graph.node_rows(dirty_ids, missing=graph.node_count)
    return np.unique(rows[rows < graph.node_count]).astype(np.int64)


def _timed_delta(driver, table, delta: dict) -> tuple:
    """driver.apply_delta(**delta) → (its dict, engine seconds, patch
    seconds): the patch is timed inside (table.patch_rows wrapped), the
    engine's apply_delta is the rest."""
    acc = {"patch_rows": 0.0}
    _timed_method(table, "patch_rows", acc)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = driver.apply_delta(**delta)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        del table.patch_rows
    return out, total - acc["patch_rows"], acc["patch_rows"]


def _check_table_rows(table, graph, rows: np.ndarray) -> None:
    """The table's rows `rows` equal _fill_table_rows (and the cumsum)
    re-derived from the engine's neighbor lists of those rows' ids under
    the table's draw keys (seed 0, phase 3's), on the card and in the
    host copy."""
    ids = graph.all_node_ids()[rows]
    offs, nbrs, ws, _ = graph.get_full_neighbor(ids)
    pad = table.pad_row
    nbr, w = _fill_table_rows(
        table.cap, pad, rows, np.diff(offs.astype(np.int64)),
        graph.node_rows(nbrs, missing=pad).astype(np.int32),
        ws.astype(np.float32), 0)
    cum = np.cumsum(w, axis=1, dtype=np.float32)
    at = torch.from_numpy(rows).to(table.neighbors.device)
    for name, got, host, want in (
            ("nbr", table.neighbors, table.host_tables[0], nbr),
            ("cum", table.cum_weights, table.host_tables[1], cum)):
        if not (np.array_equal(got[at].cpu().numpy(), want)
                and np.array_equal(host[rows], want)):
            raise AssertionError(f"patched {name} rows differ from the rows "
                                 "re-derived from the engine")


def _check_device_is_host(table, what: str) -> None:
    for got, host in ((table.neighbors, table.host_tables[0]),
                      (table.cum_weights, table.host_tables[1])):
        if not torch.equal(got, torch.from_numpy(host).to(got.device)):
            raise AssertionError(f"{what}: the card's table differs from "
                                 "its host copy")


def phase_stream_delta(store, table, graph, root: str, full_build_s: float,
                       dev: torch.device) -> dict:
    """Phase 9k (a) and (c), on the flagship's graph and table (its host
    copy kept) while the quality workers run: a K = 32 estimator trains a
    window (the graph captured on the table's tensors) and exports the
    phase's first bundle, which an InferenceServer on the card loads;
    then STREAM_EDGES new edges go through StreamingDriver.apply_delta,
    the patch is checked row by row, the estimator replays over the old
    tensors and captures again after the re-merge, graph against eager
    on the patched table, and export_and_swap promotes a fresh bundle
    into the server; then the reference's acceptance round. Every later
    phase runs on the patched graph and table. full_build_s: phase 3's
    table build, printed beside the patch. Returns the record."""
    n = graph.node_count
    rng = np.random.default_rng(STREAM_SEED)
    sample = graph.get_full_neighbor(graph.all_node_ids()[:256])[2]
    if not (sample == 1.0).all():
        raise AssertionError("the flagship's edges should weigh 1")
    gather_mean.launches = 0
    est = flagship_estimator(store, table, graph, dev, steps_per_loop=LOOP_K)
    est.train(est.train_input_fn, max_steps=LOOP_K)   # eager, then capture
    launches_prev = gather_mean.launches
    t0 = time.monotonic()
    prev = est.export_bundle(os.path.join(root, "stream0"), index=False,
                             version="stream0")
    t_prev = time.monotonic() - t0
    launches_prev = gather_mean.launches - launches_prev
    old = dict(table.tables)
    old_copy = {k: v.clone() for k, v in old.items()}
    src = rng.integers(0, n, STREAM_EDGES).astype(np.uint64)
    dst = rng.integers(0, n, STREAM_EDGES).astype(np.uint64)
    delta = {"edge_src": src, "edge_dst": dst,
             "edge_weights": np.ones(STREAM_EDGES, np.float32)}
    rows = _dirty_rows(graph, delta_dirty_ids(**delta))
    count0 = _stream_counts()
    srv = InferenceServer(prev, device=dev, service="stream_flagship",
                          max_batch=64, flush_ms=2.0)
    try:
        with ServingClient(endpoints=f"hosts:127.0.0.1:{srv.port}",
                           service="stream_flagship") as cli:
            driver = StreamingDriver(est, graph, device_table=table,
                                     serving_client=cli, export_dir=root)
            a, t_engine, t_patch = _timed_delta(driver, table, delta)
            st = a["table"]
            if not (st["upload"] == "row_scatter"
                    and st["rows_patched"] == rows.size
                    and st["grown_rows"] == 0):
                raise AssertionError(f"edge-only patch: {st}")
            _check_device_is_host(table, "edge-only patch")
            untouched = torch.ones(n + 1, dtype=torch.bool, device=dev)
            untouched[torch.from_numpy(rows).to(dev)] = False
            for k, t in table.tables.items():
                if t.data_ptr() == old[k].data_ptr() or \
                        est.static_batch[k] is not old[k]:
                    raise AssertionError(f"{k}: the patch wrote in place, or "
                                         "the estimator reads the new tensor")
                if not (torch.equal(t[untouched], old_copy[k][untouched])
                        and torch.equal(old[k], old_copy[k])):
                    raise AssertionError(f"{k}: untouched rows changed")
            _check_table_rows(table, graph, rows)
            del old_copy, untouched
            # the captured loop goes on over the old tensors; the re-merge
            # captures again
            est.train(est.train_input_fn, max_steps=2 * LOOP_K)
            before_merge = (est._graphed.captures, est._graphed.replays)
            est.static_batch.update(table.tables)
            est.train(est.train_input_fn, max_steps=4 * LOOP_K)
            loop = est._graphed
            if before_merge != (1, 1) or (loop.captures, loop.replays) != \
                    (2, 2) or loop.launches_per_replay != LOOP_K:
                raise AssertionError(
                    f"loop: captures/replays {before_merge} before the "
                    f"re-merge, {(loop.captures, loop.replays)} after, "
                    f"{loop.launches_per_replay} launches a replay")
            gve = check_graph_vs_eager(
                lambda k: flagship_estimator(store, table, graph, dev,
                                             steps_per_loop=k),
                flagship_estimator(store, table, graph, dev)
                .train_input_fn(), what="flagship, patched table")
            launches_train = gather_mean.launches - launches_prev
            t0 = time.monotonic()
            s = driver.export_and_swap(version="stream1", index=False)
            t_export_swap = time.monotonic() - t0
            launches_export = gather_mean.launches - launches_train - \
                launches_prev
            (reply,) = s["swap"].values()
            info = cli.info()
            q = np.unique(src[:8])
            served = cli.embed(q)
            new = ModelBundle.load(s["bundle_dir"], verify=False)
            if info["bundle_version"] != "stream1" or \
                    not np.array_equal(served, _resolve(new, q)) or \
                    np.array_equal(served, _resolve(prev, q)):
                raise AssertionError("the served rows of dirty nodes are not "
                                     "the new bundle's")
            del new
    finally:
        srv.stop()
    moved = {k: v - count0[k] for k, v in _stream_counts().items()}
    want = {"streaming_deltas_total": 1, "streaming_exports_total": 1,
            "streaming_swaps_total": 1,
            "alias_rows_patched_total": rows.size}
    if moved != want:
        raise AssertionError(f"counters moved {moved}, not {want}")
    if launches_export == 0 or launches_train == 0:
        raise AssertionError("streaming: gather_mean was not launched")
    out = {"edges": STREAM_EDGES, "epoch": a["epoch"], "dirty": a["dirty"],
           "table": st, "engine_apply_delta_seconds": t_engine,
           "patch_rows_ms": t_patch * 1e3, "counters": moved,
           "previous_export_seconds": t_prev,
           "previous_export_launches": launches_prev,
           "captures_before_merge": before_merge[0],
           "replays_before_merge": before_merge[1],
           "captures": loop.captures, "replays": loop.replays,
           "gather_mean_launches_per_replay": loop.launches_per_replay,
           "train_host_launches": launches_train,
           "export_launches": launches_export,
           "export_and_swap_seconds": t_export_swap, "swap_reply": reply,
           "graph_vs_eager": gve}
    log(f"streaming (a): {STREAM_EDGES} new edges on the {n}-node engine: "
        f"apply_delta {t_engine:.3f}s (epoch {a['epoch']}); patch_rows "
        f"{t_patch * 1e3:.1f} ms, {st['rows_patched']} rows "
        f"(rebuild_frac {st['rebuild_frac']:.4f}, {st['upload']}) against "
        f"the full build's {full_build_s:.1f}s; new tensors, untouched "
        f"rows bit-equal, dirty rows re-derived from the engine, card == "
        f"host; the loop replayed over the old tables, recaptured after "
        f"the re-merge ({loop.captures} captures, {loop.replays} replays, "
        f"gather_mean {loop.launches_per_replay} a replay, "
        f"{launches_train} host launches); export_and_swap "
        f"{t_export_swap:.2f}s (gather_mean {launches_export} launches), "
        f"the served rows of dirty nodes the new bundle's; counters "
        f"{moved}")
    for v in ("stream0", "stream1"):
        shutil.rmtree(os.path.join(root, v), ignore_errors=True)
    del est, driver, prev, old
    gc.collect()
    return {"edge_only": out,
            "round": stream_round(os.path.join(root, "round"), dev)}


def start_stream_growth(graph) -> dict:
    """Phase 9k (b), first half: STREAM_GROW new nodes, each with
    STREAM_GROW_DEG edges to existing nodes and their reverses, applied
    to the flagship's engine on a thread of its own (the engine rebuilds
    its snapshot in native code, without the interpreter lock) while the
    phases that do not read the flagship's engine run. Returns the
    growth's state for finish_stream_growth."""
    n = graph.node_count
    rng = np.random.default_rng(STREAM_SEED + 1)
    new_ids = np.arange(n, n + STREAM_GROW, dtype=np.uint64)
    g_src = np.repeat(new_ids, STREAM_GROW_DEG)
    g_dst = rng.integers(0, n, g_src.size).astype(np.uint64)
    grow = {"node_ids": new_ids,
            "node_types": np.full(STREAM_GROW, 2, np.int32),
            "edge_src": np.concatenate([g_src, g_dst]),
            "edge_dst": np.concatenate([g_dst, g_src]),
            "edge_weights": np.ones(2 * g_src.size, np.float32)}
    state = {"delta": grow, "n": n}

    def apply():
        t0 = time.perf_counter()
        try:
            state["epoch"] = graph.apply_delta(**grow)
        except BaseException as e:  # re-raised by finish_stream_growth
            state["error"] = e
        state["seconds"] = time.perf_counter() - t0

    state["thread"] = threading.Thread(target=apply, daemon=True)
    state["thread"].start()
    return state


def finish_stream_growth(table, graph, state: dict) -> dict:
    """Phase 9k (b), second half: wait for the engine's growth, then
    patch the flagship's table ("replace": grown_rows == STREAM_GROW),
    the old rows' pad sentinels remapped, the dirty rows re-derived from
    the engine, card == host."""
    t0 = time.monotonic()
    state["thread"].join()
    waited = time.monotonic() - t0
    if "error" in state:
        raise state["error"]
    n, grow = state["n"], state["delta"]
    prev = table.host_tables[0]
    count0 = _stream_counts()["alias_rows_patched_total"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = table.patch_rows(graph, delta_dirty_ids(**grow))
    torch.cuda.synchronize()
    t_patch = time.perf_counter() - t0
    rows = _dirty_rows(graph, delta_dirty_ids(**grow))
    if not (st["upload"] == "replace" and st["grown_rows"] == STREAM_GROW
            and st["rows_patched"] == rows.size
            and table.pad_row == n + STREAM_GROW
            and table.neighbors.shape[0] == n + STREAM_GROW + 1
            and _stream_counts()["alias_rows_patched_total"] - count0
            == rows.size):
        raise AssertionError(f"growth patch: {st}")
    _check_device_is_host(table, "growth patch")
    keep = np.ones(n, bool)
    keep[rows[rows < n]] = False
    remapped = np.where(prev[:n][keep] == n, n + STREAM_GROW, prev[:n][keep])
    if not np.array_equal(table.host_tables[0][:n][keep], remapped):
        raise AssertionError("growth: old rows' pad sentinels not remapped")
    _check_table_rows(table, graph, rows)
    out = {"nodes": STREAM_GROW, "edges": int(grow["edge_src"].size),
           "epoch": state["epoch"], "table": st,
           "engine_apply_delta_seconds": state["seconds"],
           "waited_seconds": waited, "patch_rows_seconds": t_patch}
    log(f"streaming (b): {STREAM_GROW} new nodes with "
        f"{grow['edge_src'].size} edges: apply_delta {state['seconds']:.3f}s "
        f"(on its own thread beside phases 9h-12; {waited:.1f}s waited "
        f"after them); patch_rows {t_patch:.2f}s ({st['upload']}, "
        f"grown_rows {st['grown_rows']}, {st['rows_patched']} rows "
        f"re-derived); old pad sentinels remapped, card == host")
    return out


def _stream_toy_graph(n: int = 32):
    """The reference's tests/test_streaming.py:_base_builder graph (n
    nodes of two types, 4n weighted typed edges, a 3-dim "feat")."""
    rng = np.random.default_rng(5)
    b = GraphBuilder()
    b.set_num_types(2, 2)
    b.set_feature(0, 0, 3, "feat")
    b.set_feature(1, 1, 0, "tags")
    ids = np.arange(1, n + 1, dtype=np.uint64)
    b.add_nodes(ids, types=(ids % 2).astype(np.int32),
                weights=np.linspace(1, 2, n).astype(np.float32))
    m = n * 4
    src = rng.integers(1, n + 1, m).astype(np.uint64)
    dst = rng.integers(1, n + 1, m).astype(np.uint64)
    et = rng.integers(0, 2, m).astype(np.int32)
    w = (rng.random(m) + 0.1).astype(np.float32)
    b.add_edges(src, dst, types=et, weights=w)
    b.set_node_dense(ids, 0, rng.random((n, 3), dtype=np.float32))
    b.set_node_sparse(ids, 1, np.arange(n + 1, dtype=np.uint64) * 2,
                      np.arange(2 * n, dtype=np.uint64))
    return b.finalize()


class _FeatEmb(torch.nn.Module):
    """The reference acceptance test's model: proj = Dense(4) of a node's
    3-dim feature, an MSE against the sum of its first 3 components."""

    def __init__(self, dim: int = 4):
        super().__init__()
        self.dim = dim
        self.proj = torch.nn.Linear(3, dim)

    def forward(self, batch):
        v = self.proj(batch["feat"])
        target = batch["feat"][:, :self.dim - 1].sum(-1, keepdim=True)
        loss = ((v - target) ** 2).mean()
        return ModelOutput(v, loss, "mse", loss)


def stream_round(root: str, dev: torch.device) -> dict:
    """tests/test_streaming.py:752-827 with the estimator and the
    InferenceServer on the card: 3 host-fed steps, bundle v1 served; one
    round adds node 901 with an edge to node 1, fine-tunes 3 steps,
    exports v2 and swaps it in; the fleet then serves v2 with one more
    id, and its kNN returns node 901."""
    g = _stream_toy_graph()
    bsz = 8

    def train_fn():
        while True:
            ids = g.sample_node(bsz, -1)
            yield {"feat": g.get_dense_feature(ids, "feat"), "infer_ids": ids}

    def sweep_fn():
        ids = g.all_node_ids()
        for i in range(0, len(ids), bsz):
            part = ids[i:i + bsz]
            if len(part) < bsz:
                part = np.concatenate(
                    [part, np.full(bsz - len(part), part[-1], np.uint64)])
            yield {"feat": g.get_dense_feature(part, "feat"),
                   "infer_ids": part}

    torch.manual_seed(0)
    est = BaseEstimator(_FeatEmb(), {"log_steps": 1000,
                                     "checkpoint_steps": 0}, device=dev)
    est.train(train_fn(), max_steps=3)
    v1 = est.export_bundle(os.path.join(root, "v1"), input_fn=sweep_fn,
                           nlist=2, nprobe=2, version="v1")
    new_id = np.uint64(901)
    t0 = time.monotonic()
    with InferenceServer(os.path.join(root, "v1"), service="stream_round",
                         max_batch=8, device=dev) as srv, \
            ServingClient(endpoints=f"hosts:127.0.0.1:{srv.port}",
                          service="stream_round") as cli:
        driver = StreamingDriver(est, g, serving_client=cli, export_dir=root)
        r = driver.round(
            {"node_ids": np.array([new_id], np.uint64),
             "edge_src": np.array([new_id], np.uint64),
             "edge_dst": np.array([1], np.uint64)},
            steps=3, train_input_fn=train_fn(), version="v2",
            input_fn=sweep_fn, nlist=2, nprobe=2)
        info = cli.info()
        nbr_ids, _ = cli.knn(np.array([new_id], np.uint64),
                             k=int(info["count"]))
        served_on = srv._engine.table.device
    secs = time.monotonic() - t0
    ok = (r["delta"]["epoch"] == 1 and r["swap"] is not None
          and info["bundle_version"] == "v2"
          and info["count"] == len(v1.ids) + 1 and new_id in nbr_ids[0]
          and new_id not in v1.ids and r["train"]["global_step"] == 6
          and served_on.type == dev.type)
    log(f"streaming (c): the reference's acceptance round on the card "
        f"({secs:.2f}s): epoch {r['delta']['epoch']}, fine-tune to step "
        f"{r['train']['global_step']}, served {info['bundle_version']} with "
        f"{info['count']} ids (v1 {len(v1.ids)}), table on {served_on}; kNN "
        f"of node 901 returns it: {new_id in nbr_ids[0]}")
    if not ok:
        raise AssertionError(f"streaming round: {r}, {info}")
    return {"seconds": secs, "epoch": r["delta"]["epoch"],
            "global_step": r["train"]["global_step"],
            "bundle_version": info["bundle_version"],
            "count": info["count"], "v1_count": len(v1.ids),
            "knn_returns_new_node": True}


def _gated_runs(table: dict, mods: dict, label: str = "") -> dict:
    """Each quality entry, name → (runner, argv, result key, row, floor,
    ref mean, ref sd, port sd, seeds), run on the card for its seeds
    through _quiet_run and logged, met or not: met when the mean lies
    within QUALITY_BAND of the RESULTS.md row or within 2 standard
    errors, sqrt(port_sd^2 / seeds + ref_sd^2 / 10), of the reference's
    10-seed mean. Fails on a non-finite run, a skipped step, a mean
    below its floor or one that meets neither gate."""
    out = {}
    for name, (runner, argv, key, row, floor, ref, ref_sd, port_sd,
               seeds) in table.items():
        what = label + name
        vals, secs = [], []
        for seed in seeds:
            res, dt = _quiet_run(mods[runner], [*argv, "--seed", str(seed)],
                                 f"{what} seed {seed}")
            vals.append(float(res[key]))
            secs.append(dt)
        mean = float(np.mean(vals))
        se = float(np.sqrt(port_sd ** 2 / len(vals) + ref_sd ** 2 / 10))
        row_met = abs(mean - row) <= QUALITY_BAND
        ref_met = abs(mean - ref) <= 2 * se
        log(f"quality: {what}: {key} " + ", ".join(f"{v:.4f}" for v in vals)
            + f" (seeds {list(seeds)}, "
            + ", ".join(f"{x:.1f}s" for x in secs)
            + f"), mean {mean:.4f}; RESULTS.md row {row} +- {QUALITY_BAND}: "
            f"{'met' if row_met else 'not met'}; the reference's 10-seed "
            f"mean {ref} +- 2 standard errors {2 * se:.4f}: "
            f"{'met' if ref_met else 'not met'}")
        if not mean >= floor:
            raise AssertionError(f"{what}: mean {mean} < {floor}")
        if not (row_met or ref_met):
            raise AssertionError(f"{what}: mean {mean} meets neither "
                                 "quality gate")
        out[name] = {"values": vals, "seconds": secs, "seeds": list(seeds),
                     "mean": mean, "row": row, "row_met": row_met,
                     "oracle": ref, "two_se": 2 * se, "oracle_met": ref_met}
    return out


def _slice11_entries(table: dict) -> dict:
    """SLICE11_QUALITY / KG_QUALITY entries in _gated_runs' layout
    (floor S11_FLOOR, seeds QUALITY_SEEDS unless the entry names its
    own)."""
    return {name: (runner, argv, key, row, S11_FLOOR, ref, ref_sd,
                   port_sd, seeds[0] if seeds else QUALITY_SEEDS)
            for name, (runner, argv, key, row, ref, ref_sd, port_sd,
                       *seeds) in table.items()}


_SLICE11_MODS = {"run_geniepath": run_geniepath,
                 "run_scalable_sage": run_scalable_sage,
                 "run_solution": run_solution}


def phase_genie_quality() -> dict:
    """The host-fed GeniePath runner on cora, the SLICE11_QUALITY entry
    with the longest runs, in a worker of its own."""
    with common.shared_graphs():
        return _gated_runs(_slice11_entries(
            {k: v for k, v in SLICE11_QUALITY.items()
             if v[0] == "run_geniepath"}), _SLICE11_MODS)


def phase_slice11_quality() -> dict:
    """The rest of slice 11's cora runners on the card, seeds 0-2 (host-
    fed scalable_sage 0-9), their defaults, against their RESULTS.md rows
    and the JAX package's own 10-seed means (SLICE11_QUALITY), over one
    cora engine; then run_sample_solution once (seed 0) against
    SAMPLE_SOLUTION_FLOOR."""
    import tempfile

    with common.shared_graphs():
        out = _gated_runs(_slice11_entries(
            {k: v for k, v in SLICE11_QUALITY.items()
             if v[0] != "run_geniepath"}), _SLICE11_MODS)
        with tempfile.TemporaryDirectory() as tmp:
            res, dt = _quiet_run(run_sample_solution,
                                 ["--model_dir", tmp, "--seed", "0"],
                                 "sample_solution")
    met = res["eval_metric"] >= SAMPLE_SOLUTION_FLOOR
    log(f"quality: sample_solution cora (seed 0, {dt:.1f}s): eval "
        f"micro-F1 {res['eval_metric']:.4f} (floor "
        f"{SAMPLE_SOLUTION_FLOOR}: {'met' if met else 'not met'})")
    if not met:
        raise AssertionError(f"sample_solution: {res['eval_metric']} < "
                             f"{SAMPLE_SOLUTION_FLOOR}")
    out["sample_solution cora"] = {"value": res["eval_metric"],
                                   "seconds": dt,
                                   "floor": SAMPLE_SOLUTION_FLOOR}
    return out


def phase_kg_quality() -> dict:
    """The knowledge-graph runners on the card, seeds 0-2, their
    defaults on the fb15k237 stand-in, against their RESULTS.md rows and
    the JAX package's own 10-seed means (KG_QUALITY), over one graph."""
    mods = {"run_transx": run_transx, "run_distmult": run_distmult,
            "run_rgcn": run_rgcn}
    with common.shared_graphs():
        return _gated_runs(_slice11_entries(KG_QUALITY), mods)


def _data_quality(runner: str) -> dict:
    """`runner`'s DATA_QUALITY entry on the synthetic ml_1m graph on the
    card, seeds 0-2, host-fed at its defaults, against its RESULTS.md
    row and the JAX package's own 10-seed mean."""
    mods = {"run_deepwalk": run_deepwalk, "run_line": run_line}
    entries = {name: (r, argv, key, row, DATA_FLOOR, ref, ref_sd, port_sd,
                      QUALITY_SEEDS)
               for name, (r, argv, key, row, ref, ref_sd, port_sd)
               in DATA_QUALITY.items() if r == runner}
    return _gated_runs(entries, mods)


def phase_graph_quality() -> dict:
    """Slice 10's runners on the card, seeds 0-2, their defaults,
    against their RESULTS.md rows and the JAX package's own 10-seed
    means (GRAPH_QUALITY), floor GRAPH_FLOOR (_gated_runs)."""
    mods = {"run_gin": run_gin, "run_graphgcn": run_graphgcn,
            "run_gated_graph": run_gated_graph, "run_set2set": run_set2set,
            "run_lgcn": run_lgcn, "run_gae": run_gae, "run_dgi": run_dgi}
    with common.shared_graphs():
        return _gated_runs(
            {name: (runner, argv, key, row, GRAPH_FLOOR, ref, ref_sd,
                    port_sd, QUALITY_SEEDS)
             for name, (runner, argv, key, row, ref, ref_sd, port_sd)
             in GRAPH_QUALITY.items()}, mods)


def phase_mp_quality() -> dict:
    """The layerwise and message-passing runners on the card, seeds 0-2,
    their defaults on cora, in one process over one cora engine (and
    one FullBatchDataFlow static batch, common.shared_graphs), against
    their RESULTS.md rows and the JAX package's own 10-seed means
    (MP_QUALITY), floor MP_FLOOR (_gated_runs)."""
    mods = {"run_fastgcn": run_fastgcn, "run_gcn": run_gcn,
            "run_gat": run_gat, "run_appnp": run_appnp,
            "run_agnn": run_agnn, "run_arma": run_arma,
            "run_sgcn": run_sgcn, "run_tagcn": run_tagcn,
            "run_adaptivegcn": run_adaptivegcn, "run_dna": run_dna}
    with common.shared_graphs():
        return _gated_runs(
            {name: (runner, argv, "test_metric", row, MP_FLOOR, ref,
                    ref_sd, port_sd, QUALITY_SEEDS)
             for name, (runner, argv, row, ref, ref_sd, port_sd)
             in MP_QUALITY.items()}, mods)


def phase_hostfed_quality() -> dict:
    """The port's host-fed runners on the card, seeds 0-2, against their
    RESULTS.md rows and the JAX package's own 10-seed means
    (HOSTFED_QUALITY, each with its floor; _gated_runs)."""
    mods = {"run_graphsage": run_graphsage, "run_deepwalk": run_deepwalk,
            "run_line": run_line}
    return _gated_runs(
        {name: (runner, argv, key, row, floor, ref, ref_sd, port_sd,
                QUALITY_SEEDS)
         for name, (runner, argv, key, row, floor, ref, ref_sd, port_sd)
         in HOSTFED_QUALITY.items()}, mods, label="host-fed ")


def phase_slice7_quality() -> dict:
    """geniepath-dev cora (run_geniepath) and graphsage-dev-cache cora
    (run_graphsage --act_cache) on the card for seeds 0-2, the runners'
    defaults: each mean against its RESULTS.md row +- 0.01 and against
    the JAX package's own 10-seed mean within 2 standard errors, each
    printed met or not; fails on a skipped step, a mean below
    SLICE7_FLOOR, or a mean that meets neither gate."""
    out = {}
    for name, mod, argv, row, (oracle, ref_sd, port_sd) in (
            ("geniepath cora", run_geniepath, ["--device_sampler"],
             GENIE_ROW, (GENIE_ORACLE, GENIE_REF_SD, GENIE_PORT_SD)),
            ("graphsage act cache cora", run_graphsage,
             ["--device_sampler", "--act_cache"], CACHE_ROW,
             (CACHE_ORACLE, CACHE_REF_SD, CACHE_PORT_SD))):
        f1 = []
        for seed in QUALITY_SEEDS:
            buf = io.StringIO()
            t0 = time.monotonic()
            with contextlib.redirect_stdout(buf):
                res = mod.main(argv + ["--seed", str(seed)])
            secs = time.monotonic() - t0
            if res["train_skipped_steps"] != 0:
                raise AssertionError(f"{name} seed {seed}: skipped steps")
            f1.append(float(res["test_metric"]))
            log(f"quality: {name} seed {seed}: test micro-F1 {f1[-1]:.4f} "
                f"(best step {res['best_step']}, {secs:.1f}s)")
        mean = float(np.mean(f1))
        gate = abs(mean - row) <= QUALITY_BAND
        two_se = 2 * float(np.sqrt(port_sd ** 2 / len(f1) + ref_sd ** 2 / 10))
        gate_se = abs(mean - oracle) <= two_se
        log(f"quality: {name} mean test micro-F1 {mean:.4f} over seeds "
            f"{list(QUALITY_SEEDS)} (floor {SLICE7_FLOOR}; RESULTS.md row "
            f"{row} +- {QUALITY_BAND}: {'met' if gate else 'not met'}; the "
            f"reference's own 10-seed mean {oracle} +- 2 standard errors "
            f"{two_se:.4f}, tests/oracle_citation.py --vary_init: "
            f"{'met' if gate_se else 'not met'})")
        if not mean >= SLICE7_FLOOR:
            raise AssertionError(f"{name} mean micro-F1 {mean} < "
                                 f"{SLICE7_FLOOR}")
        if not (gate or gate_se):
            raise AssertionError(
                f"{name} mean micro-F1 {mean}: neither within "
                f"{QUALITY_BAND} of RESULTS.md's {row} nor within "
                f"{two_se} of the reference's 10-seed mean {oracle}")
        out[name] = {"test_micro_f1": f1, "mean": mean, "row": row,
                     "gate_met": gate, "oracle": oracle, "two_se": two_se,
                     "gate_two_se_met": gate_se}
    return out


def phase_unsup_quality() -> dict:
    """The port's unsupervised runners on the card with the reference's
    defaults: DeepWalk and LINE on the cora stand-in against their
    RESULTS.md rows, unsupervised GraphSAGE on the ppi stand-in for
    seeds 0-2 against the JAX package's own 10-seed mean, within 2
    standard errors of the difference. Fails on a non-finite run, a
    skipped step,
    or an MRR below its floor; prints each gate and whether it was
    met."""
    out = {}
    for name, mod, argv, row in (
            ("deepwalk cora", run_deepwalk, ["--device_sampler"],
             DEEPWALK_ROW),
            ("line cora", run_line, ["--device_sampler"], LINE_ROW)):
        res, secs = _quiet_run(mod, argv, name)
        m = res["eval_metric"]
        gate = abs(m - row) <= QUALITY_BAND
        log(f"quality: {name}: eval MRR {m:.4f} ({res['train_global_step']} "
            f"steps, {secs:.1f}s; floor {UNSUP_FLOOR}; RESULTS.md row {row} "
            f"+- {QUALITY_BAND}: {'met' if gate else 'not met'})")
        if not m >= UNSUP_FLOOR:
            raise AssertionError(f"{name}: eval MRR {m} < {UNSUP_FLOOR}")
        out[name] = {"eval_mrr": m, "row": row, "gate_met": gate,
                     "result": res}
    mrr = []
    for seed in QUALITY_SEEDS:
        res, secs = _quiet_run(
            run_graphsage, ["--device_sampler", "--mode", "unsupervised",
                            "--dataset", "ppi", "--seed", str(seed)],
            f"ppi seed {seed}")
        mrr.append(res["eval_metric"])
        log(f"quality: unsupervised GraphSAGE ppi seed {seed}: eval MRR "
            f"{mrr[-1]:.4f} ({secs:.1f}s)")
    mean = float(np.mean(mrr))
    se = float(np.sqrt(PPI_PORT_SD ** 2 / len(mrr) + PPI_REF_SD ** 2 / 10))
    gate = abs(mean - PPI_ORACLE) <= 2 * se
    log(f"quality: unsupervised GraphSAGE ppi mean eval MRR {mean:.4f} over "
        f"seeds {list(QUALITY_SEEDS)} (floor {PPI_FLOOR}; the reference's "
        f"own 10-seed mean {PPI_ORACLE} +- 2 standard errors {2 * se:.4f}, "
        f"tests/oracle_unsup_ppi.py: {'met' if gate else 'not met'})")
    if not mean >= PPI_FLOOR:
        raise AssertionError(f"ppi mean eval MRR {mean} < {PPI_FLOOR}")
    out["graphsage unsup ppi"] = {"eval_mrr": mrr, "mean": mean,
                                  "oracle": PPI_ORACLE, "two_se": 2 * se,
                                  "gate_met": gate}
    return out


def _quiet_run(mod, argv, name):
    """mod.main(argv) on the card with its output kept from the log;
    raises on a non-finite run or a skipped step."""
    buf = io.StringIO()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(buf):
        res = mod.main(argv)
    secs = time.monotonic() - t0
    if res["train_skipped_steps"] or res["train_skipped_batches"]:
        raise AssertionError(f"{name}: skipped steps or batches: {res}")
    if not all(np.isfinite(res[k]) for k in
               ("train_loss", "eval_loss", "eval_metric")):
        raise AssertionError(f"{name}: non-finite result: {res}")
    return res, secs


def phase_quality() -> dict:
    """fit_citation on the cora stand-in through the port's runner, on
    the card, one run per seed; the runner's own output goes to the
    record."""
    f1, logs = [], []
    for seed in QUALITY_SEEDS:
        buf = io.StringIO()
        t0 = time.monotonic()
        with contextlib.redirect_stdout(buf):
            res = run_graphsage.main(["--device_sampler", "--int8_features",
                                      "--seed", str(seed)])
        secs = time.monotonic() - t0
        logs.append(buf.getvalue())
        if res["train_skipped_steps"] != 0:
            raise AssertionError(f"cora seed {seed}: skipped steps")
        f1.append(float(res["test_metric"]))
        log(f"quality: cora seed {seed}: test micro-F1 {f1[-1]:.4f} "
            f"(best step {res['best_step']}, {secs:.1f}s)")
    mean = float(np.mean(f1))
    gate = abs(mean - QUALITY_ROW) <= QUALITY_BAND
    log(f"quality: cora mean test micro-F1 {mean:.4f} over seeds "
        f"{list(QUALITY_SEEDS)} (floor {QUALITY_FLOOR}; RESULTS.md row "
        f"{QUALITY_ROW} +- {QUALITY_BAND}: {'met' if gate else 'not met'})")
    if not mean >= QUALITY_FLOOR:
        raise AssertionError(f"cora mean micro-F1 {mean} < {QUALITY_FLOOR}")
    return {"seeds": list(QUALITY_SEEDS), "test_micro_f1": f1,
            "mean": mean, "gate_met": gate, "logs": logs}


def phase_small_vs_cpu(dev: torch.device) -> dict:
    """A small input through the card (kernel) and through the CPU path
    (plain versions) with the same weights and replayed uniforms: the
    embeddings agree within 1e-4 (int8 + float32 scale)."""
    g = synthetic_citation(n=2000, d=FEAT_DIM, num_classes=NUM_CLASSES,
                           seed=1, intra_degree=6.0, inter_degree=2.0)
    feats = np.concatenate([g.features, np.zeros((1, FEAT_DIM), np.float32)])
    labels = np.concatenate([g.onehot_labels(),
                             np.zeros((1, NUM_CLASSES), np.float32)])
    model = DeviceSampledGraphSage(
        NUM_CLASSES, FEAT_DIM, multilabel=False, dim=DIM, fanouts=FANOUTS,
        uniform_sampling=True, generator=torch.Generator().manual_seed(1))
    rng = np.random.default_rng(2)
    roots = rng.integers(0, 2000, 64).astype(np.int32)
    uniforms, n = [], len(roots)
    for k in FANOUTS:
        uniforms.append(rng.random((n, k), dtype=np.float32))
        n *= k
    embs = []
    for d in (dev, torch.device("cpu")):
        store = DeviceFeatureStore.from_arrays(feats, labels,
                                               quantize="int8", device=d)
        tab = DeviceNeighborTable.from_csr(g.offsets, g.neighbors, cap=CAP,
                                           device=d)
        m = model.to(d)
        batch = {"rows": [torch.from_numpy(roots).to(d)], "sample_seed": 0,
                 "sample_uniforms": [torch.from_numpy(u).to(d)
                                     for u in uniforms],
                 **tab.tables, "feature_table": store.features,
                 "feature_scale": store.feature_scale,
                 "label_table": store.labels}
        with torch.inference_mode():
            embs.append(m(batch).embedding.cpu())
    err = max_abs_err(embs[0], embs[1])
    if not err <= 1e-4:
        raise AssertionError(f"card vs CPU on a small input: {err} > 1e-4")
    log(f"small input: card vs CPU embeddings max abs err {err:.3g} "
        f"(tol 1e-4)")
    return {"max_abs_err": err, "tol": 1e-4}


def phase_export(est, out_dir: str, version: str, what: str) -> tuple:
    """export_bundle from a trained flagship estimator: the embedding
    sweep over every node (gather_mean once per forward), the files with
    their sha256, then a verified load. index=False at this width: the
    reference's IVF build is host k-means whose per-centroid mask loop
    rereads the whole table 64 times an iteration for 10 iterations,
    minutes of host time and none of the card's (ROADMAP performance
    queue). Returns (record, the ModelBundle)."""
    forwards = -(-len(est.split_ids(est.infer_node_type)) // est.batch_size)
    torch.cuda.synchronize()
    gather_mean.launches = 0
    t0 = time.monotonic()
    bundle = est.export_bundle(out_dir, index=False, version=version)
    t_export = time.monotonic() - t0
    launches = gather_mean.launches
    if launches != forwards:
        raise AssertionError(f"{what}: gather_mean launched {launches} "
                             f"times for {forwards} sweep forwards")
    if bundle.embeddings.shape != (FULL_NODES, 2 * DIM) or \
            not np.isfinite(bundle.embeddings).all():
        raise AssertionError(f"{what}: embeddings {bundle.embeddings.shape} "
                             "or non-finite")
    if not np.array_equal(bundle.ids, est.feature_store.ids):
        raise AssertionError(f"{what}: bundle ids are not the store's")
    t0 = time.monotonic()
    loaded = ModelBundle.load(out_dir, verify=True)
    t_verify = time.monotonic() - t0
    if not (np.array_equal(loaded.ids, bundle.ids)
            and np.array_equal(loaded.embeddings, bundle.embeddings)):
        raise AssertionError(f"{what}: the verified load differs")
    del loaded
    nbytes = sum(os.path.getsize(os.path.join(out_dir, f))
                 for f in os.listdir(out_dir))
    r = {"version": version, "global_step": bundle.meta["global_step"],
         "forwards": forwards, "gather_mean_launches": launches,
         "rows": bundle.count, "dim": bundle.dim, "bundle_bytes": nbytes,
         "export_save_seconds": t_export, "verify_load_seconds": t_verify}
    log(f"export {what}: {bundle.count} ids x {bundle.dim} f32 at step "
        f"{r['global_step']}, gather_mean launches {launches} == "
        f"{forwards} forwards; export_bundle (sweep + host copy + save + "
        f"sha256) {t_export:.2f}s, verified load {t_verify:.2f}s; bundle "
        f"{nbytes} bytes; IVF index off at this width (host k-means, see "
        f"the phase's docstring)")
    return r, bundle


def lat_summary(lats_s: list) -> dict:
    """Counted order statistics of a sorted list of seconds, in ms."""
    def pct(p):
        return lats_s[min(int(len(lats_s) * p), len(lats_s) - 1)] * 1e3 \
            if lats_s else None

    return {"p50_ms": pct(0.50), "p99_ms": pct(0.99), "p999_ms": pct(0.999),
            "max_ms": lats_s[-1] * 1e3 if lats_s else None}


def _closed_loop(port: int, ids: np.ndarray, verb: str, threads: int,
                 reqs: int, check=None, until=None) -> dict:
    """SERVE_THREADS-style closed-loop clients, one ServingClient each,
    SERVE_IDS random ids per request (tools/bench_serve.py:run_leg's
    shape): `reqs` requests a thread, or while until() is false. check
    (q, answer) holds each answer. Latencies at the client, retries
    included; lost = sent - answered - errors (must be 0)."""
    mu = threading.Lock()
    lats, spans, errors, bad, sent = [], [], [0], [], [0]
    pol = RetryPolicy(deadline_s=30.0, call_timeout_s=20.0)

    def worker(widx: int):
        rng = np.random.default_rng(widx)
        with ServingClient(endpoints=f"hosts:127.0.0.1:{port}",
                           retry_policy=pol) as cli:
            i = 0
            while (i < reqs) if until is None else not until():
                i += 1
                q = ids[rng.integers(0, len(ids), SERVE_IDS)]
                with mu:
                    sent[0] += 1
                t0 = time.monotonic()
                try:
                    out = cli.score(q, q[::-1].copy()) if verb == "score" \
                        else cli.embed(q)
                except Exception as e:  # an explicit status: counted
                    with mu:
                        errors[0] += 1
                        bad.append(repr(e))
                    continue
                t1 = time.monotonic()
                with mu:
                    lats.append(t1 - t0)
                    spans.append((t0, t1))
                if check is not None:
                    err = check(q, out, t0)
                    if err:
                        with mu:
                            bad.append(err)

    ts = [threading.Thread(target=worker, args=(i,)) for i in range(threads)]
    t_wall = time.monotonic()
    for t in ts:
        t.start()
    for t in ts:
        t.join(SERVE_JOIN_S)
    wall = time.monotonic() - t_wall
    if any(t.is_alive() for t in ts):
        raise AssertionError(f"{verb}: client threads still running after "
                             f"{SERVE_JOIN_S}s")
    n = len(lats)
    lats.sort()
    return {"verb": verb, "threads": threads, "requests": n,
            "errors": errors[0], "lost": sent[0] - n - errors[0],
            "reqs_per_s": n / wall, "wall_s": wall, **lat_summary(lats),
            "spans": spans, "bad": bad[:5], "n_bad": len(bad)}


def serve_leg(bundle, dev, verb: str, max_batch: int, flush_ms: float,
              ids: np.ndarray) -> dict:
    """One latency leg against a fresh replica over the in-memory bundle
    (its table uploaded anew): batch-1 (max_batch 1, flush_ms 0) or
    micro-batched; nothing injected, the card's apply is the cost."""
    srv = InferenceServer(bundle, device=dev, service=f"leg_{verb}",
                          replica=max_batch, max_batch=max_batch,
                          flush_ms=flush_ms)
    try:
        r = _closed_loop(srv.port, ids, verb, SERVE_THREADS, SERVE_REQS)
        health = srv.health()
        shapes = srv.padded_shapes_seen()
    finally:
        srv.stop()
    del r["spans"]
    r.update(mode="batch1" if max_batch == 1 else f"flush{flush_ms:g}ms",
             max_batch=max_batch, flush_ms=flush_ms, shed=health["shed"],
             padded_shapes=shapes)
    if r["lost"] or r["errors"] or r["n_bad"]:
        raise AssertionError(f"serve leg {verb} {r['mode']}: {r}")
    if max(shapes.values()) > len(srv.ladder):
        raise AssertionError(f"{verb}: padded shapes {shapes} > ladder "
                             f"{srv.ladder}")
    log(f"serve leg {verb} {r['mode']} (max_batch {max_batch}, flush_ms "
        f"{flush_ms:g}): {r['requests']} requests from {SERVE_THREADS} "
        f"threads x {SERVE_IDS} ids, p50 {r['p50_ms']:.3f} ms, p99 "
        f"{r['p99_ms']:.3f} ms, p999 {r['p999_ms']:.3f} ms, "
        f"{r['reqs_per_s']:.1f} req/s, shed {r['shed']}, lost {r['lost']}")
    return r


def _resolve(bundle, q: np.ndarray) -> np.ndarray:
    """The bundle's rows for ids q, zero rows for unknown ids."""
    rows = np.searchsorted(bundle.ids, q).clip(0, bundle.count - 1)
    out = bundle.embeddings[rows].copy()
    out[bundle.ids[rows] != q] = 0.0
    return out


def phase_serve(v1, dir_v1: str, v2, dir_v2: str, root: str,
                dev: torch.device) -> dict:
    """The serving stack on the card through the real TCP path: v1's
    bundle loaded (verified) by an InferenceServer; embed exact, score
    within its bound, exact knn byte-identical to brute_force over the
    table; batch-1 against micro-batched latency legs for embed and
    score; a hot-swap to v2 under embed traffic (0 lost, answers after
    the flip v2's); a 2-shard fleet of v1 (two replicas on the card, a
    dir: registry) whose scatter-gather knn is byte-identical to
    brute_force over the unsharded table."""
    out = {}
    rng = np.random.default_rng(5)
    unknown = np.uint64(int(v1.ids[-1]) + 1_000_000_007)
    knn_q = []
    for _ in range(SERVE_KNN_REQS):
        q = v1.ids[rng.integers(0, v1.count, SERVE_IDS)]
        q[0] = unknown if len(knn_q) % 2 else q[0]
        knn_q.append(q)
    t0 = time.monotonic()
    knn_want = [brute_force(v1.embeddings, v1.ids, _resolve(v1, q), SERVE_K)
                for q in knn_q]
    t_ref = time.monotonic() - t0
    # -- load v1 from disk and check its answers -------------------------
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    t0 = time.monotonic()
    srv = InferenceServer(dir_v1, device=dev, service="serve_v1",
                          max_batch=64, flush_ms=2.0)
    t_load = time.monotonic() - t0
    eng = srv._engine
    loaded = {"load_seconds": t_load, "upload_seconds": eng.upload_seconds,
              "table_device": str(eng.table.device),
              "table_bytes": eng.table.numel() * eng.table.element_size(),
              "device_bytes_after_load": torch.cuda.memory_allocated(),
              "device_bytes_before_load": base}
    if eng.table.device.type != dev.type:
        raise AssertionError(f"served table on {eng.table.device}")
    try:
        with ServingClient(endpoints=f"hosts:127.0.0.1:{srv.port}") as cli:
            bound = 0.0
            for i in range(SERVE_CHECK_REQS):
                q = v1.ids[rng.integers(0, v1.count, 64)]
                q[i % 64] = unknown
                want = _resolve(v1, q)
                if not np.array_equal(cli.embed(q), want):
                    raise AssertionError("embed disagrees with the bundle")
                dst = q[rng.permutation(64)]
                wd = _resolve(v1, dst)
                got = cli.score(q, dst)
                ref = np.einsum("ij,ij->i", want, wd)
                # float32 sum of D products: |error| <= D u sum|a_i b_i|
                # (u = 2^-24) for each side's order
                tol = 2 * (2 * DIM) * 2.0 ** -24 * np.einsum(
                    "ij,ij->i", np.abs(want), np.abs(wd))
                err = np.abs(got - ref)
                if not (err <= tol + 1e-30).all():
                    raise AssertionError(f"score: {err.max()} > bound")
                bound = max(bound, float((err / np.maximum(tol, 1e-30))
                                         .max()))
            t0 = time.monotonic()
            for q, (w_nbr, w_sims) in zip(knn_q, knn_want):
                nbr, sims = cli.knn(q, k=SERVE_K)
                if not (np.array_equal(nbr, w_nbr)
                        and np.array_equal(sims, w_sims)):
                    raise AssertionError("knn is not byte-identical to "
                                         "brute_force over the table")
            t_knn = time.monotonic() - t0
            info = cli.info()
        loaded.update(knn_requests=SERVE_KNN_REQS,
                      knn_seconds_per_request=t_knn / SERVE_KNN_REQS,
                      brute_force_seconds_per_request=t_ref / SERVE_KNN_REQS,
                      score_err_share_of_bound=bound,
                      bundle_version=info["bundle_version"])
    finally:
        srv.stop()
    del srv, eng
    out["load"] = loaded
    log(f"serve: v1 loaded (sha256-verified) in {t_load:.2f}s, table "
        f"upload {loaded['upload_seconds']:.3f}s, "
        f"{loaded['table_bytes']} bytes on {loaded['table_device']}; device "
        f"bytes {base} -> {loaded['device_bytes_after_load']}; "
        f"{SERVE_CHECK_REQS} embed requests (64 ids, one unknown) exact, "
        f"score within {bound:.3g} of its bound; {SERVE_KNN_REQS} exact "
        f"knn ({SERVE_IDS} ids, k {SERVE_K}) byte-identical to "
        f"brute_force, {t_knn / SERVE_KNN_REQS * 1e3:.1f} ms/request "
        f"(host numpy)")
    # -- latency legs (tools/bench_serve.py:serve_smoke's shape) ----------
    gc.collect()
    out["legs"] = [serve_leg(v1, dev, verb, mb, fl, v1.ids)
                   for verb in ("embed", "score")
                   for mb, fl in SERVE_LEGS]
    # -- hot-swap to v2 under embed traffic ---------------------------------
    gc.collect()
    srv = InferenceServer(v1, device=dev, service="serve_swap",
                          max_batch=64, flush_ms=2.0)
    flip = {"done": None}
    after = [0]
    mu = threading.Lock()

    def check(q, got, t_sent):
        v2_rows = np.array_equal(got, _resolve(v2, q))
        if flip["done"] is not None and t_sent > flip["done"]:
            with mu:
                after[0] += 1
            return None if v2_rows else "v1 rows after the flip"
        return None if v2_rows or np.array_equal(got, _resolve(v1, q)) \
            else "rows of neither version"

    def until():
        return flip["done"] is not None and after[0] >= SERVE_AFTER_SWAP

    res, abort = {}, threading.Event()

    def drive():
        try:
            res.update(_closed_loop(
                srv.port, v1.ids, "embed", SERVE_THREADS, 0, check,
                lambda: abort.is_set() or until()))
        except BaseException as e:  # re-raised on the main thread
            res["raised"] = e

    traffic = threading.Thread(target=drive)
    try:
        traffic.start()
        time.sleep(0.5)  # traffic under way before the swap
        torch.cuda.synchronize()
        before_swap = torch.cuda.memory_allocated()
        with ServingClient(endpoints=f"hosts:127.0.0.1:{srv.port}") as adm:
            t_a = time.monotonic()
            (reply,) = adm.swap_fleet(dir_v2).values()
            t_b = time.monotonic()
        flip["done"] = t_b
        traffic.join(SERVE_JOIN_S)
        if traffic.is_alive():
            raise AssertionError("swap traffic did not finish")
        version, health = srv.bundle_version, srv.health()
        shapes = srv.padded_shapes_seen()
    finally:
        abort.set()
        srv.stop()
        traffic.join(SERVE_JOIN_S)
    if "raised" in res:
        raise res["raised"]
    during = [t1 - t0 for t0, t1 in res["spans"] if t1 >= t_a and t0 <= t_b]
    swap = {"seconds": t_b - t_a, "reply": reply, "version": version,
            "requests": res["requests"], "lost": res["lost"],
            "errors": res["errors"], "bad": res["bad"],
            "answers_after_flip": after[0],
            "requests_during_swap": len(during),
            "worst_ms_during_swap": max(during) * 1e3 if during else None,
            "p50_ms": res["p50_ms"], "p99_ms": res["p99_ms"],
            "max_ms": res["max_ms"], "swaps": health["swaps"],
            "device_bytes_before_swap": before_swap,
            "padded_shapes": shapes}
    out["swap"] = swap
    if res["lost"] or res["errors"] or res["n_bad"] or version != "v2" \
            or reply["previous_version"] != "v1" or health["swaps"] != 1:
        raise AssertionError(f"hot-swap: {swap}")
    if max(shapes.values()) > len(srv.ladder):
        raise AssertionError(f"swap: padded shapes {shapes}")
    log(f"serve swap v1 -> v2 under {SERVE_THREADS} embed threads: "
        f"{swap['seconds']:.2f}s (verified load + upload beside v1 + warm), "
        f"{res['requests']} requests, lost {res['lost']}, errors "
        f"{res['errors']}; {len(during)} requests overlapped the swap, the "
        f"worst {swap['worst_ms_during_swap']:.1f} ms; {after[0]} answers "
        f"sent after the flip, all v2's rows; version {version}")
    # -- a 2-shard fleet of v1 on the card ----------------------------------
    gc.collect()
    fleet_dir = os.path.join(root, "v1_fleet")
    t0 = time.monotonic()
    v1.save_sharded(fleet_dir, 2, index=False)
    t_shard = time.monotonic() - t0
    spec = f"dir:{os.path.join(root, 'registry')}"
    t0 = time.monotonic()
    srvs = [InferenceServer(fleet_dir, device=dev, registry=spec,
                            service="fleet", shard=s, max_batch=64,
                            flush_ms=2.0) for s in range(2)]
    t_start = time.monotonic() - t0
    try:
        with ServingClient(registry=spec, service="fleet") as cli:
            if cli.shards() != [0, 1]:
                raise AssertionError(f"fleet shards {cli.shards()}")
            t0 = time.monotonic()
            for q, (w_nbr, w_sims) in zip(knn_q, knn_want):
                nbr, sims = cli.knn(q, k=SERVE_K)
                if not (np.array_equal(nbr, w_nbr)
                        and np.array_equal(sims, w_sims)):
                    raise AssertionError("fleet knn is not byte-identical "
                                         "to brute_force")
            t_fleet = time.monotonic() - t0
            merges = cli.health()["fanout"]["merges"]
        tables = [s._engine.table for s in srvs]
        if any(t.device.type != dev.type for t in tables):
            raise AssertionError("a shard's table is not on the card")
        rows = [int(t.shape[0]) for t in tables]
    finally:
        for s in srvs:
            s.stop()
    out["fleet"] = {"shards": 2, "rows": rows,
                    "save_sharded_seconds": t_shard,
                    "start_seconds": t_start, "knn_requests": len(knn_q),
                    "merges": merges,
                    "knn_seconds_per_request": t_fleet / len(knn_q)}
    log(f"serve fleet: save_sharded(2) {t_shard:.2f}s, 2 shard replicas "
        f"({rows[0]} + {rows[1]} rows on the card) started in "
        f"{t_start:.2f}s; {len(knn_q)} scatter-gather knn byte-identical "
        f"to brute_force over the unsharded table, {merges} merges, "
        f"{t_fleet / len(knn_q) * 1e3:.1f} ms/request")
    return out


# the quality phases run in six worker processes, started after the
# build and joined before the first timed phase: their runs are small on
# the card and bound by the host, so they overlap the host-bound graph
# set-up (phase 3) and phase 9k (a), (c), and no timed phase. The groups
# balance their run times (in-worker seconds of one H100 run: the cora
# protocol, slice 7, unsupervised and host-fed runners 293 s; the
# message-passing runners 268 s; slice 10's 270 s; host-fed GeniePath
# 229 s; LINE on ml_1m 302 s; the KG runners, DeepWalk on ml_1m and the
# rest of slice 11 ~220 s). Runners of one process share one engine per
# dataset (common.shared_graphs).
QUALITY_WORKERS = (("quality", "slice7_quality", "unsup_quality",
                    "hostfed_quality"), ("mp_quality",), ("graph_quality",),
                   ("genie_quality",), ("line_ml_1m_quality",),
                   ("kg_quality", "deepwalk_ml_1m_quality",
                    "slice11_quality"))


def run_quality_group(names) -> dict:
    """The quality phases `names` in this process, TF32 off as phase 1
    sets it; {name: record}."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phases = {"quality": phase_quality,
              "slice7_quality": phase_slice7_quality,
              "unsup_quality": phase_unsup_quality,
              "hostfed_quality": phase_hostfed_quality,
              "mp_quality": phase_mp_quality,
              "graph_quality": phase_graph_quality,
              "genie_quality": phase_genie_quality,
              "slice11_quality": phase_slice11_quality,
              "kg_quality": phase_kg_quality,
              "deepwalk_ml_1m_quality": lambda: _data_quality("run_deepwalk"),
              "line_ml_1m_quality": lambda: _data_quality("run_line")}
    out, t0 = {}, time.monotonic()
    for name in names:
        out[name] = phases[name]()
        log(f"[{time.monotonic() - t0:.1f}s in its worker] {name} done")
    return out


def _quality_worker(names, conn) -> None:
    """A quality worker's body: run_quality_group with its log captured;
    sends ("ok", records, log) or ("error", traceback, log)."""
    import traceback

    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            out = run_quality_group(names)
        conn.send(("ok", out, buf.getvalue()))
    except BaseException:  # the parent reports it and fails the run
        conn.send(("error", traceback.format_exc(), buf.getvalue()))
    finally:
        conn.close()


def start_quality_workers() -> list:
    """One spawned process per QUALITY_WORKERS group, each with its own
    CUDA context; [(names, process, pipe)]."""
    ctx = multiprocessing.get_context("spawn")
    workers = []
    for names in QUALITY_WORKERS:
        recv, send = ctx.Pipe(duplex=False)
        proc = ctx.Process(target=_quality_worker, args=(names, send),
                           daemon=True)
        proc.start()
        send.close()
        workers.append((names, proc, recv))
    return workers


def finish_quality_workers(workers, record: dict) -> None:
    """Wait for every worker, print its log, merge its records; raise if
    one failed or died."""
    failed = []
    for names, proc, recv in workers:
        try:
            status, payload, text = recv.recv()
        except EOFError:
            proc.join()
            status, payload, text = "error", (
                f"the worker of {names} died (exit code {proc.exitcode}) "
                "and sent nothing"), ""
        proc.join()
        sys.stdout.write(text)
        sys.stdout.flush()
        if status == "ok":
            record.update(payload)
        else:
            failed.append(payload)
    if failed:
        raise AssertionError("a quality worker failed:\n"
                             + "\n".join(failed))


def stop_quality_workers(workers) -> None:
    """Stop any worker still running (the run failed before joining)."""
    for _, proc, _ in workers:
        if proc.is_alive():
            proc.terminate()
        proc.join()


def mark(record: dict, what: str, t_start: float) -> None:
    """The seconds from the start to the end of a phase, logged and
    kept in the record (phase_end_seconds)."""
    t = time.monotonic() - t_start
    record.setdefault("phase_end_seconds", {})[what] = t
    log(f"[{t:.1f}s] {what} done")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="also write the full record as JSON to this path")
    ap.add_argument("--extra-loop-k", type=int, action="append", default=[],
                    help="also time the loop phase at this steps_per_loop "
                         "(repeatable); phase 7 always runs K = 32")
    ap.add_argument("--baseline-source", default=None,
                    help="an earlier gather_mean.cu with the first kernel's "
                         "C entry, timed against the current one")
    args = ap.parse_args(argv)
    t_start = time.monotonic()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    record = {"device": phase_device()}
    record["build"], baseline = phase_build(args.baseline_source)
    bundles = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "chip_smoke_bundles")
    shutil.rmtree(bundles, ignore_errors=True)
    os.makedirs(bundles)
    workers = start_quality_workers()
    try:
        store, table, graph, record["graph"] = phase_graph(dev)
        mark(record, "graph", t_start)
        # slice 12: graphs that change, on the flagship's graph and table,
        # beside the quality workers (the engine rebuilds its snapshot)
        record["streaming"] = phase_stream_delta(
            store, table, graph, bundles, record["graph"]["table_seconds"],
            dev)
        mark(record, "streaming (a), (c)", t_start)
        finish_quality_workers(workers, record)
        mark(record, "quality (workers beside the graph set-up)", t_start)
    finally:
        stop_quality_workers(workers)
    model = DeviceSampledGraphSage(
        NUM_CLASSES, FEAT_DIM, multilabel=False, dim=DIM, fanouts=FANOUTS,
        uniform_sampling=table.uniform_rows,
        generator=torch.Generator().manual_seed(0)).to(dev).eval()
    inf = NodeInferencer(model, store, table, batch_size=BATCH)
    probe = {**next(inf.infer_input_fn(np.arange(BATCH, dtype=np.uint64))),
             **inf.static_batch}
    with torch.inference_mode():
        deepest = model.sample_rows(probe)[-1].view(BATCH * FANOUTS[0], -1)
        # the activation cache's one hop of 15 over the same roots
        cache_rows = sample_hop(
            table.neighbors, table.cum_weights, probe["rows"][0],
            CACHE_FANOUT, torch.Generator(device=dev).manual_seed(1),
            uniform=table.uniform_rows).view(BATCH, CACHE_FANOUT)
    record["kernels"] = phase_kernels(store, deepest, dev, baseline,
                                      cache_rows)
    del deepest, probe, cache_rows
    record["slice"], ids, emb = phase_slice(inf, model)
    mark(record, "kernels, slice", t_start)
    del ids, emb
    record["peak_device_bytes"] = torch.cuda.max_memory_allocated()
    dir_v1, dir_v2 = (os.path.join(bundles, v) for v in ("v1", "v2"))
    record["train"], est = phase_train(store, table, graph, dev)
    record["export_v1"], v1 = phase_export(est, dir_v1, "v1",
                                           "v1 (phase 6's weights)")
    mark(record, "train, export v1", t_start)
    # phase 9l's cluster: dumped and loaded on a thread of its own while
    # the K = 32 phases keep the card busy and the host idle
    service = start_graph_service(graph)
    try:
        record["loop"], est = phase_loop(store, table, graph, dev)
        record["export_v2"], v2 = phase_export(
            est, dir_v2, "v2", "v2 (the K = 32 phase's weights)")
        mark(record, "loop, export v2", t_start)
        del est
        record["loop"]["graph_vs_eager"] = check_graph_vs_eager(
            lambda k: flagship_estimator(store, table, graph, dev,
                                         steps_per_loop=k),
            flagship_estimator(store, table, graph, dev).train_input_fn())
        record["loop_extra"] = [phase_loop(store, table, graph, dev, k)[0]
                                for k in args.extra_loop_k]
        mark(record, "loop graph vs eager", t_start)
        # slice 14: multi-device training as an NCCL world of one
        record["mesh"] = phase_mesh(store, table, graph, dev)
        mark(record, "mesh", t_start)
        # the unsupervised family on the same graph: negatives over every
        # node's unit weight, as bench.py builds them (bench.py:411-419)
        neg = DeviceNodeSampler(graph, node_type=-1, device=dev)
        record["unsup"] = phase_unsup(store, table, neg, graph, dev)
        mark(record, "unsup", t_start)
        record["walk"] = phase_walk(table, neg, graph, dev)
        record["embedding_backward"] = probe_embedding_backward(table, dev)
        mark(record, "walk", t_start)
        # slice 7: the fused and alias layouts of the same table, the
        # flagship over each, the activation cache, the unsupervised family
        # over the alias layout
        record["layouts"], fused, alias = phase_layouts(table, dev)
        mark(record, "layouts", t_start)
        record["fused"] = phase_layout_flagship(
            store, table, graph, dev, fused, "fused",
            against=("split weighted", lambda k: flagship_estimator(
                store, table, graph, dev, uniform=False,
                steps_per_loop=k)))
        record["alias"] = phase_layout_flagship(store, table, graph, dev,
                                                alias, "alias")
        mark(record, "fused, alias", t_start)
        record["act_cache"] = phase_act_cache(store, table, graph, dev)
        mark(record, "act cache", t_start)
        record["alias_unsup"] = phase_alias_unsup(store, table, neg, alias,
                                                  graph, dev)
        record["hostfed"] = phase_hostfed(store, graph, dev)
        mark(record, "alias family, host-fed", t_start)
        # slice 13: the graph service, trained from a 2-shard cluster of
        # the same (patched) graph
        record["graph_service"] = phase_graph_service(store, graph,
                                                      service, dev)
        mark(record, "graph service", t_start)
    finally:
        if "graph_service" not in record:
            stop_graph_service(service)
    # slice 9: the layerwise family on the same tables (split and alias),
    # then full-batch message passing on the pubmed stand-in
    record["layerwise"] = phase_layerwise(store, table, graph, alias, dev)
    mark(record, "layerwise", t_start)
    # no later phase reads the flagship's engine: it grows on a thread of
    # its own beside them (phase 9k (b))
    growth = start_stream_growth(graph)
    del neg, fused, alias
    record["fullbatch"] = phase_fullbatch(dev)
    mark(record, "fullbatch", t_start)
    # slice 10: graph classification and the GAE / DGI / LGCN zoo
    record["zoo"] = phase_zoo(dev)
    mark(record, "zoo", t_start)
    # slice 11: the rest of the node zoo and the knowledge-graph family
    record["slice11"] = phase_slice11(dev)
    mark(record, "slice 11", t_start)
    record["small_vs_cpu"] = phase_small_vs_cpu(dev)
    mark(record, "small", t_start)
    # the training tables go before the bundles' tables go on the card,
    # but for the neighbor table, which phase 9k (b) grows after serving
    del store, inf, model
    gc.collect()
    torch.cuda.empty_cache()
    log(f"serve: {torch.cuda.memory_allocated()} device bytes allocated "
        f"after freeing the training tables but the neighbor table")
    try:
        record["serve"] = phase_serve(v1, dir_v1, v2, dir_v2, bundles, dev)
        mark(record, "serve", t_start)
    finally:
        shutil.rmtree(bundles, ignore_errors=True)
    record["streaming"]["growth"] = finish_stream_growth(table, graph, growth)
    mark(record, "streaming (b)", t_start)
    del table, graph
    main_case = record["kernels"]["cases"][0]
    kernels = {"kernels": [{
        "name": "gather_mean", "route": "cuda",
        "source": "euler_tpu_torch/csrc/gather_mean.cu",
        "replaces": "euler_tpu/ops/pallas_ops.py:105",
        "replaces_function": "euler_tpu/ops/pallas_ops.py:"
                             "_pallas_gather_mean",
        "launches": record["slice"]["gather_mean_launches"],
        "train_launches": record["train"]["gather_mean_launches"],
        "loop_host_launches": record["loop"]["gather_mean_host_launches"],
        "loop_launches_per_replay":
            record["loop"]["gather_mean_launches_per_replay"],
        "loop_replays": record["loop"]["replays"],
        "loop_device_launches":
            record["loop"]["gather_mean_device_launches"],
        "unsup_launches": record["unsup"]["k1"]["gather_mean_launches"],
        "unsup_loop_host_launches":
            record["unsup"]["k32"]["gather_mean_host_launches"],
        "unsup_loop_launches_per_replay":
            record["unsup"]["k32"]["gather_mean_launches_per_replay"],
        "unsup_loop_replays": record["unsup"]["k32"]["replays"],
        "unsup_loop_device_launches":
            record["unsup"]["k32"]["gather_mean_device_launches"],
        "walk_device_launches":
            record["walk"]["gather_mean_device_launches"],
        "export_launches": record["export_v1"]["gather_mean_launches"],
        "export_v2_launches": record["export_v2"]["gather_mean_launches"],
        "fused_loop_device_launches":
            record["fused"]["gather_mean_device_launches"],
        "fused_loop_launches_per_replay":
            record["fused"]["gather_mean_launches_per_replay"],
        "alias_loop_device_launches":
            record["alias"]["gather_mean_device_launches"],
        "alias_loop_launches_per_replay":
            record["alias"]["gather_mean_launches_per_replay"],
        "act_cache_launches": record["act_cache"]["k1"][
            "gather_mean_launches"],
        "act_cache_loop_device_launches":
            record["act_cache"]["k32"]["gather_mean_device_launches"],
        "act_cache_loop_launches_per_replay":
            record["act_cache"]["k32"]["gather_mean_launches_per_replay"],
        "act_cache_refresh_launches":
            record["act_cache"]["refresh"]["gather_mean_launches"],
        "alias_unsup_launches_per_replay":
            record["alias_unsup"]["unsup"]["gather_mean_launches_per_replay"],
        "alias_walk_launches_per_replay":
            record["alias_unsup"]["walk"]["gather_mean_launches_per_replay"],
        "hostfed_launches": record["hostfed"]["gather_mean_launches"],
        "graph_service_launches": sum(
            record["graph_service"][f"feeders_{k}"]["gather_mean_launches"]
            for k in (0, *GRAPH_FEEDERS)),
        "layerwise_launches": record["layerwise"]["k1"][
            "gather_mean_launches"],
        "layerwise_loop_device_launches": record["layerwise"]["k32_split"][
            "gather_mean_device_launches"],
        "layerwise_alias_loop_device_launches": record["layerwise"][
            "k32_alias"]["gather_mean_device_launches"],
        "fullbatch_launches": sum(r["gather_mean_launches"]
                                  for r in record["fullbatch"].values()),
        "zoo_launches": sum(r["gather_mean_launches"]
                            for r in record["zoo"].values()
                            if isinstance(r, dict)),
        "scalable_hostfed_launches": record["slice11"]["scalable_sage"][
            "gather_mean_launches"],
        "scalable_hostfed_steps": record["slice11"]["scalable_sage"][
            "steps"],
        "slice11_other_launches": sum(
            r["gather_mean_launches"]
            for k, r in record["slice11"].items()
            if isinstance(r, dict) and k != "scalable_sage"),
        "streaming_host_launches": record["streaming"]["edge_only"][
            "train_host_launches"],
        "streaming_loop_launches_per_replay": record["streaming"][
            "edge_only"]["gather_mean_launches_per_replay"],
        "streaming_loop_replays": record["streaming"]["edge_only"][
            "replays"],
        "streaming_export_launches": record["streaming"]["edge_only"][
            "export_launches"],
        "streaming_graph_vs_eager_launches_per_replay": record["streaming"][
            "edge_only"]["graph_vs_eager"]["gather_mean_launches_per_replay"],
        "mesh_loop_launches_per_replay": record["mesh"]["flagship"]["mesh"][
            "gather_mean_launches_per_replay"],
        "mesh_collectives_per_step": record["mesh"]["collectives_per_step"],
        "launched": record["slice"]["gather_mean_launches"] > 0,
        "checked_vs_plain": True,
        "max_abs_err": main_case["max_abs_err"],
        "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
        "cases": record["kernels"]["cases"]}]}
    record["seconds"] = time.monotonic() - t_start
    log(f"chip_smoke: {record['seconds']:.1f}s from start to the result")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
