#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``pathtracing_tpu_torch``).

    python3 chip_smoke.py            # needs one CUDA device and nvcc

Drives the port's main paths — golden scene -> pack -> render -> BGRA ->
BMP: the scan on the binary BVH tables (every ray query served by the
``ray_query`` kernel), the scan on a scene packed with the wide-BVH
mega-table (every ray query served by the ``wide_ray_query`` kernel, pinned
with ``megakernel=False``), and ``render_frame`` on that wide scene, which on
the card renders through the ``megakernel`` kernel (whole paths, one launch
per spp chunk) — at the PRODUCTION preset's geometry (1920x1080, 5 bounces)
with spp cut from 1024 to 8 (one motion-blur step); ``render_frame(...,
wavefront=True)`` on the binary scene, which on the card renders through the
``wavefront`` kernel (whole paths for any pixel list, one launch per tile and
spp chunk); the row-gather probe (``gather_rows`` kernel); the animated
frame loop, the system's own main path, through the port's CLI
(``python -m pathtracing_tpu_torch.cli``: ``load_scene``, whose placement
rays the ``ray_query`` kernel traces, ``setup_animation_frame``, the chunked
``DevicePacker``, frames by the ``megakernel`` kernel up to the production
preset's geometry at 128 spp and by the ``wavefront`` kernel); the Cornell
box's area lights, adaptive sampling, AOVs and denoiser (K8); and the gradient
path, ``diff/render.make_fast_grad_frame_fn`` on that frame at 1 spp: the
megakernel's record build (``megakernel_record`` kernel, K6) records the
hit topology, and autograd through the scan's replay runs the gathers'
backward kernels (``small_table_grad`` K7a for the subframe tables,
``row_grad`` K7b for the vertex, instance and triangle tables). Every
kernel is held against its plain PyTorch version and, where there is one,
against the C++ oracle's goldens on the way.
Phases, one JSON object per line:

  device            card name + power limit (nvidia-smi), torch / CUDA versions
  build             the twelve libraries of csrc/ (the path kernels' area-light
                    instances are two of them, the instances that walk bf16
                    node rows three more: ray_query_nl5, wavefront_nl5,
                    wavefront_nl5_lit), built side by side: seconds,
                    ptxas' registers and spills per kernel, resident blocks
                    per SM of the ray-query kernels and the path kernels'
                    first design; wide_ray_query's and ray_query's registers
                    and spills as they were before their walks moved into
                    wide_walk.cuh and binary_walk.cuh, and the path kernels'
                    timed builds (K2 and K5, first design and wide block) as
                    recorded in K2_TIMED and K5_TIMED. The phases below up
                    to gather_probe need only P1's, K1's and P2's libraries
                    and run while the path kernels' libraries build (their
                    lines come before build's)
  scene, wide_scene table sizes; rows and bytes of the wide tables per layout
  kernel_check      ray_query kernel vs plain version: the 4096 rays of
                    rays.gold in five modes, and the two batches the main path
                    gives it (primary: one tile of camera rays; bounce: 2 x
                    tile shadow+bounce rays with a per-lane any-hit mask and
                    inactive lanes); a launch's edge cases (1, 31, 33, 4097
                    lanes, all inactive, all active, active only in the last
                    warp, two launches in a row). ids equal, thit/u/v within
                    rtol=1e-6, atol=1e-6; vs the oracle columns at
                    tests/test_traversal.py's bars. Kernel / plain times, the
                    plain version's row-read counts, the bound (the table
                    rows the batch touched), simd_efficiency and the
                    active-warp share of each batch.
  bounded_walk_check P1's bounded query (ray_query(max_steps=,
                    return_state=), the library's second kernel) on the
                    bounce batch, nl8 and nl5 rows: the lanes' completion
                    steps swept through ray_query (p50 ... p100, as
                    tools/stress_probe.py reads them), the walk state at 8,
                    64 and the longest lane's steps bit-equal to the plain
                    version's on every field, the hits at the longest lane's
                    steps bit-equal to the unbounded query's; timed beside it
  wide_kernel_check wide_ray_query kernel, layouts w8, w16, s8: the same
                    modes plus a per-lane tmin, vs its plain version (same
                    bars), vs the oracle, vs the ray_query kernel on the same
                    rays (ids may differ on exactly equal t only: <= 0.2 %);
                    then for w8 the two main-path batches: vs plain, and its
                    time beside the ray_query kernel's on the same batch in
                    the same call, row counts, the bound, lane fill and the
                    share of row visits on the hottest rows of 160 KB, the
                    longest walk beside the path kernels' step cap; w16
                    and s8 on the primary batch, timed beside w8.
  breakdown         one tile x one sample: time inside the kernel vs the rest
  gather_probe      gather_rows kernel bit-equal to index_select on the
                    probe's four shapes (2 tables x 2 batches) at k = 1, 16,
                    32 and on three hostile lists (every lane on one row, a
                    sorted list, one non-empty bucket); the counting pass's
                    order a permutation of [0, R) in ascending buckets; each
                    shape's time beside index_select's (L2 flushed, median
                    of 5), device time split into counting pass and copy,
                    bound; k = 4, 8, 16, 32 on the large table; the probe's
                    harness times
  oracle_frame, oracle_frame_wide, oracle_frame_megakernel,
  oracle_frame_wavefront
                    TESTING preset 640x360, spp 8, 4 bounces vs render8.gold:
                    the scan on the binary and the wide scene, the
                    megakernel on the wide one, the wavefront on the binary
                    one
  megakernel_check  the megakernel vs its plain version (path_trace_megakernel_plain)
                    on the golden 640x360 frame: spp 1, spp 4 from sample 5,
                    a pixel base with a ragged slot count, a Morton pixel
                    order, the luminance-squared plane, and on motion.gold's
                    scene (four distinct subframe rows) a negative sample
                    base and one past the rows; finite share, share within
                    the JAX bar, bit-equal share, worst lanes; two launches
                    byte-equal; no sample abandoned, and at a step cap of 8
                    rows samples abandoned, counted, and only their pixels
                    changed
  wavefront_check   the wavefront kernel vs its plain version
                    (path_trace_wavefront_plain) on the binary, w8, w16 and
                    s8 scenes: a random list with duplicates, spp 1, spp 4
                    from sample 5, the luminance-squared plane, ragged counts
                    1 / 31 / 33 / 4097, an empty list, motion.gold's scene
                    from sample -3 and from 37; two launches byte-equal; on
                    w8 bit-equal to the megakernel on the row-major list; a
                    cap of 8 rows abandons samples and counts them; the
                    device-side average and tonemap of both fused renderers
                    at spp 3 byte-equal to the host's
  main_path, main_path_wide, main_path_megakernel, main_path_wavefront
                    the frame above; finite radiance, launch counts, BMP
                    written; the wide frame against the binary frame, the
                    megakernel's against the wide scan frame, the
                    wavefront's against the binary scan frame (and a second
                    fused frame byte-equal to the first; its host steps one
                    by one)
  tonemap_check     BGRA made on the card: trace.gold's tonemap inputs
                    tonemapped on the card against the oracle's bytes (within
                    1 LSB, the CPU test's bar), and a 1080p colour frame
                    made on the card tonemapped on the card and on the CPU
                    (within 1 LSB); the shares of equal bytes
  megakernel_timing, wavefront_timing
                    one launch at the main path's shape (L2 flushed) and its
                    bound from the counting build's counters of the same
                    work; the wavefront on the binary and the w8 scene, timed
                    in turns with the megakernel
  bf16_nodes_check  S2 on the golden scene: with_bf16_nodes on the card
                    byte-equal to pack_nl5 on the CPU; the ray_query kernel's
                    nl5 instance vs its plain version on rays.gold in every
                    mode and the edge cases, and on the main path's primary
                    and bounce batches (the bounce batch as captured, all
                    closest, all any-hit), vs the nl8 instance (closest-hit
                    fields bit-equal, occluded equal, the any-hit lanes'
                    equal share printed), both batches timed nl5 vs nl8 in
                    turns with the bound by 32 B sectors; the 1080p scan
                    frame on nl5 rows (P1 nl5 launches only) vs the nl8
                    frame; the K5 frame on nl5 rows (K5 nl5 only) within the
                    JAX bar of the nl5 scan frame and vs the nl8 K5 frame;
                    one K5 launch nl5 vs nl8 in turns with its bound; the
                    Cornell box's light instance on nl5 rows (frame vs nl8,
                    launch vs its plain version and nl8)
  tuning_check      the rows get_tuning("cuda", ...) returns; a 640x360 scan
                    frame under a PT_TUNED_FILE (in a temporary directory)
                    whose cuda row halves the tile: twice the P1 launches,
                    colours bit-equal
  large_scene       the procedural large scene (scene/large_scene.build:
                    the generated terrain at 512 x 512 vertices under
                    build/large_scene/, 1,024 pine and bunny instances, a
                    camera looking down onto it; ~0.52 M triangles, tables
                    5-6x the L2), built through SceneBuilder.build on the
                    card by the native OBJ loader and BVH builders
                    (required): triangles, instances, each table's bytes
                    against the L2, host seconds per stage, peak memory
  large_scene_ray_queries
                    P1 and K1 on 65,536 of its frame's rays (the primary and
                    the first bounce batch) against their plain versions
                    (ids equal, 1e-6), timed (median of 5, L2 flushed) with
                    device time and the bound by bytes from the rows the
                    plain walks touched; both at a render tile's batches
  large_scene_frames
                    1920x1080 x 5 bounces x 8 spp on it by the scan (binary,
                    w8), K2 (w8) and K5 (binary, w8): seconds, Msamples/s,
                    peak memory, launches; K2 and K5 against the scan frame
                    on the same tables (the JAX bar), bit-equal share
  large_scene_path_timing
                    one K2 w8, K5 binary and K5 w8 launch at 8 spp over the
                    frame: median of 5, device time, bound
  large_scene_record
                    one K6 launch at 1080p x 1 spp: every record plane equal
                    to the scan's; its time, device time and bound; the
                    share of primary rays that hit (must be >= 50 %) and
                    that hit a placed object (must be > 0)
  bf16_nodes_large  S2 on the large scene: the binary tables' bytes with nl8
                    and nl5; P1 nl5 vs its plain version and vs P1 nl8 on the
                    65,536-ray batches, nl5 vs nl8 in turns on them and on a
                    render tile's batches (time, device time, bound by the
                    32 B sectors the visited rows span); the scan frame on
                    nl5 rows vs the nl8 frame; one 8 spp K5 launch nl5 vs
                    nl8 in turns, within the JAX bar of the nl5 scan frame
  animation_load, animation_frames, animation_chunked_k1,
  animation_subframes, animation_cli
                    the animated frame loop (phase_animation_cli), the
                    system's own main path, on the reference's animated
                    scene from stand-in meshes written to build/animation/:
                    load_scene's placement traced on the card (one P1
                    launch) equal to the CPU's, bit for bit; for frames 1000
                    and 1750 at 1080p x 8 spp the chunked frame tables
                    packed on the card byte-equal to the CPU's pack, the K2
                    frame within the JAX bar of the scan frame on the
                    binary frame tables (P1), K1 on the chunked tables
                    (65,536 rays, primary and bounce batch) equal to its
                    plain version and to P1, one 2 spp K2 launch timed;
                    frame 1000 set up at 64 and at 1024 spp (8 and 128
                    subframes, a dynamic TLAS each): the card's pack equal
                    to the CPU's, and on the two samples across the last two
                    subframes K2 (chunked), K5 (chunked, bit-equal to K2)
                    and K5 (binary) within the JAX bar of the scan (P1);
                    then the CLI in processes of its own: frames 1000-1002
                    at 64 spp by K2, frame 1000 at 128 spp (64 K2
                    launches), frame 1000 at 64 spp by K5 on the binary
                    frame tables, samples [0, 4) + [4, 8) (two processes
                    at once with S10's --shard run, beside the subframe
                    checks) merged by the CLI's --merge in this process
                    (within 1 LSB of the in-process K2 frame); each run's
                    launches
                    (P1 in load_scene, the frames' kernel only), seconds,
                    Msamples/s, peak memory and table bytes, every BMP
                    required, and the device's idle share of the first K2
                    frame of the 64 and the 128 spp run, from the trace
                    that the CLI's --profile-dir takes of that frame
  animation_nl5     one 8 spp K5 launch on frame 1000's binary frame tables
                    with bf16 node rows (with_bf16_nodes on the frame
                    packer's nl8) vs nl8, in turns; within the JAX bar of the
                    scan frame
  arealight_check   S9's area lights: K2 (w8) and K5 (binary, w8) with light
                    tables (their AreaLights instances) vs their plain
                    versions at 640x360 x 5 bounces on the Cornell box and on
                    a panel scene of 144 light rows (build/arealights/):
                    spp 1, spp 4 from sample 5 with the lum^2 plane, one
                    launch each counted; two launches byte-equal; the
                    counting build's light samples and pdfs; the scan with
                    lights on the card vs the CPU's on 4,096 lanes
  arealight_timing  one 1080p x 8 spp launch of each light instance on the
                    Cornell box (K2 w8, K5 w8, K5 binary): time (L2
                    flushed, median of 3), device time, bound from the
                    counting build; the scan on the same work once
  cornell_cli       the Cornell box through the CLI at 1920x1080 x 5 bounces
                    x 64 spp by K2 and by K5 (--wavefront): launches,
                    seconds, Msamples/s, peak; the two BMPs equal
  adaptive_cli      the CLI's --adaptive 8 --spp 64 --aovs --wavefront on the
                    Cornell box: pass 1 (K2 with lum^2), pass 2 (K5 a
                    bucket) and the AOV pass (K1) in ms, launches, the AOV
                    file; pass 2 on a 640x360 list by K5 and by the scan
  denoise_check     K8 vs its plain version on the Cornell box's 1080p frame
                    (render_with_variance's 8 spp frame and noise map,
                    render_aovs' guides) at radius 2 and 4, with and without
                    the noise map (rtol 1e-5, atol 1e-6 max|ref|), and on
                    seeded edge cases (1x1, 7x1000, 1081x1921; radius 0, 1,
                    9 and one past the tile's shared memory on 5x7;
                    extreme values; noise map and +inf), by each design
                    where it fits (denoise_checks: the wrapper's choice;
                    denoise_designs: bit-equal shares, quality, registers,
                    shared memory, SASS mix of the tap loop); one launch
                    through
                    joint_bilateral_denoise counted; the denoised frame
                    nearer a 64 spp frame than the 8 spp one; each radius
                    timed with device time and bound, and the designs in
                    turns on the Cornell frame and random guides
                    (denoise_design_times)
  record_check      the megakernel's record build (K6) vs its plain version
                    (path_trace_megakernel_plain(record=True)) on w8, w16, s8
                    and motion.gold's scene, spp 1 and spp 3: every record
                    plane equal, sums byte-equal to K2's; the replay of K6's
                    records bit-equal to the direct scan with no walk
                    launched; two launches byte-equal; with_stats,
                    pixel_order and area lights raise
  grad_kernel_check the gathers' backward kernels (K7a small_table_grad, K7b
                    row_grad), each in both designs (K7a first / grid, K7b
                    first / counting), vs their plain versions (index_add_
                    in double) on the inputs of one all-fields replay chunk
                    of the 1080p frame (the chunk with the most primary
                    triangle hits; each K7b input labelled by its shade and
                    table: vattr (R, 3) x 12, inst_f (R,) x 21, tri_pos (R,)
                    x 12) and on seeded random inputs of 2,073,600 lanes
                    with heavy duplication (rtol 1e-5, atol 1e-6 max|ref|);
                    two launches byte-equal; times of both designs in turns
                    beside the plain versions, index_add_ in float (and
                    K7a's one-hot matmul), bound by bytes, and each
                    design's split (host enqueue time; device time per
                    kernel from torch.profiler); K7b timed on the shade
                    with the fewest all-zero vattr cotangent rows, which
                    must be fewer than all, on its three tables
  grad_slow_check   render_value_and_grad vs make_fast_grad_fn on 4,096 lanes
                    of the 640x360 frame, binary, binary with bf16 node rows
                    (P1's nl5 instance only; the loss bit-equal to nl8's) and
                    w8, at tests/test_diff_fast.py's bar; P1 / K1 launch
                    counts
  main_path_grad    make_fast_grad_frame_fn at 1920x1080, 5 bounces, 1 spp,
                    w8: a step on every field (finite loss; finite, non-zero
                    gradients), then 3 steps of inverse sun whose error must
                    fall; launches of K6, K7a, K7b (and none of P1, K1, K2,
                    K5); peak memory; a warm step; the step by its pieces
                    (K6 record, replay without autograd, the loss's
                    cotangent, replays under autograd, backwards); one
                    replay chunk under torch.profiler, whose backward must
                    run no indexing_backward kernel
  record_timing     one K6 launch at that shape, timed in turns with K2's;
                    the plain version's time, and its records and sums
                    against K6's of that shape (every plane equal, sums
                    byte-equal to K2's); the bound
  phase_split       the path kernels' phase-cycle build at 1080p x 8 spp (K2
                    on w8, K5 on binary and w8; the first design and the wide
                    block): each phase's share of the summed clock64() cycles
                    (camera/RNG, closest walk, shadow walk, shading fetch,
                    atmosphere, NEE, sample_bsdf, other); sums byte-equal to
                    the timed build's
  design_timing     the path kernels' two designs (first: 128 threads a
                    block; wide: 512, one block an SM) in one call, in turns,
                    L2 flushed: K2 w8/w16/s8 and K5 binary/w8 at 1080p x 8
                    spp on the row-major frame, K2 w8 with a Morton and with
                    a shuffled pixel_order, K5 w8 and binary on a shuffled
                    list, K6 at 1080p x 1 spp; median and spread of 3; their
                    sums byte-equal; registers, spills and resident blocks
                    of each design; the design the wrapper takes
  S10 (sharding):
  shard_check       K2 and K5 (binary) sharded at 1080p x 8 spp on the meshes
                    (4, 1), (2, 2), (1, 4): tiles x samples launches; bit-equal
                    to one launch with tiles only, else to the shard-order
                    sum of single-device launches over the same ranges, and
                    within the JAX bar of one launch; the scan shards (P1,
                    K1) on a 640x360 list at (2, 2); render_frame_sharded by
                    K5 on this machine's mesh
  multihost_check   parallel.multihost_demo with 2 processes (an all_reduce,
                    round-robin frames by P1 on the card, byte-identical to
                    one process's), run beside megakernel_check and
                    wavefront_check
  geomshard_check   the large scene split over 2 and 4 geometry shards (one
                    without instances) and a (geom 2, tiles 2) mesh: per-shard
                    table bytes; the 1080p x 1 spp scan, P1 per shard per
                    bounce, against the replicated scan frame
  hotperm_check     the animated frame packed with hot_rows=1024 on the card,
                    equal to the CPU's pack; K1 batches and a 2 spp K2
                    launch bit-equal to the unpermuted pack's, K2 timed in
                    turns on both
  packer_options_check (S11) the animated frame packed with chunk_max 256,
                    octants=1 and bake_static beside the base pack: each pack
                    on the card equal to the CPU's, its rows, bytes and
                    packer seconds; K1 batches equal to the plain wide walk
                    on each, their ids against the base pack's; one 2 spp K2
                    launch within the JAX bar of the base pack's, one K5
                    (w8) launch bit-equal to it; K2 timed on the four packs
                    in turns beside their rows a ray. setup_animation_frame
                    (build_tlas_trees=False) at 1024 spp against True: host
                    seconds, the wide tables and root cursors byte-equal, a
                    K2 launch bit-equal
  shard_cli         the CLI's --shard --wavefront at 1080p x 8 spp: one K5
                    launch a card, within 1 LSB of the in-process K2 frame
  shard_grad_check  make_sharded_fast_grad_frame at 1080p x 1 spp on (4, 1)
                    (4 K6 launches) against main_path_grad's step;
                    make_sharded_render_grad on 4,096 lanes on (1, 2)
  kernels           the per-kernel summary line
and last ``{"ok": true, "device": {...}}``. Any failed phase raises: the
script exits non-zero and prints no result line. There is no CPU fallback:
without a CUDA device it exits 2 at once. Imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import pathlib
import re
import shutil
import signal
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from torch.profiler import ProfilerActivity
from torch.profiler import profile as torch_profile

from pathtracing_tpu_torch import cli as port_cli
from pathtracing_tpu_torch import models, tuning
from pathtracing_tpu_torch.accel.chunks import CHUNK_MAX
from pathtracing_tpu_torch.accel.wide import (
    LAYOUT_S8,
    LAYOUT_W8,
    LAYOUT_W16,
    LAYOUTS_BY_WIDTH,
)
from pathtracing_tpu_torch.adaptive import render_adaptive, render_with_variance
from pathtracing_tpu_torch.aov import render_aovs
from pathtracing_tpu_torch.config import PRODUCTION, TESTING
from pathtracing_tpu_torch.denoise import DEFAULT_SIGMAS, denoise_plain, joint_bilateral_denoise
from pathtracing_tpu_torch.io.bmp import read_bmp, write_bmp
from pathtracing_tpu_torch.diff import render as diff_render
from pathtracing_tpu_torch.diff.render import (
    DIFFERENTIABLE_FIELDS,
    frame_items,
    make_fast_grad_fn,
    make_fast_grad_frame_fn,
    render_value_and_grad,
    replay_value_and_grad,
)
from pathtracing_tpu_torch.ops import cuda_build
from pathtracing_tpu_torch.ops import cuda_denoise as CD
from pathtracing_tpu_torch.ops import cuda_gather_grad as CG
from pathtracing_tpu_torch.ops import cuda_megakernel as CM
from pathtracing_tpu_torch.ops import cuda_traversal as CT
from pathtracing_tpu_torch.ops import cuda_wavefront as CWF
from pathtracing_tpu_torch.ops import cuda_wide_traversal as CW
from pathtracing_tpu_torch.ops import integrator
from pathtracing_tpu_torch.ops import megakernel as mk_module
from pathtracing_tpu_torch.ops.megakernel import (
    morton_pixel_order,
    path_trace_megakernel,
    path_trace_megakernel_plain,
)
from pathtracing_tpu_torch.ops.integrator import path_trace_samples
from pathtracing_tpu_torch.ops.tonemap import tonemap
from pathtracing_tpu_torch.ops.traversal import (
    _TravState,
    ray_query,
    ray_query_plain,
    simd_efficiency,
)
from pathtracing_tpu_torch.ops.wavefront import (
    path_trace_wavefront,
    path_trace_wavefront_plain,
)
from pathtracing_tpu_torch.ops.wide_traversal import wide_ray_query_plain
from pathtracing_tpu_torch.parallel.geomshard import build_shard_scenes, make_geom_sharded_render
from pathtracing_tpu_torch.parallel.multihost import local_device_mesh
from pathtracing_tpu_torch.parallel.sharding import (
    Mesh,
    make_mesh,
    make_sharded_fast_grad_frame,
    make_sharded_render,
    make_sharded_render_grad,
    make_sharded_render_megakernel,
    render_frame_sharded,
)
from pathtracing_tpu_torch.probes import gather_probe as GP
from pathtracing_tpu_torch.render import (
    LARGE_SCENE_NODES,
    _average,
    _bgra,
    _mk_spp_chunk,
    _render_fused,
    _row_major,
    default_tile_pixels,
    render_frame,
    render_pixels,
    to_bgra,
)
from pathtracing_tpu_torch.scene import large_scene
from pathtracing_tpu_torch.scene.builder import SceneBuilder
from pathtracing_tpu_torch.scene.device import (
    DevicePacker,
    binary_tables,
    pack_nl5,
    with_bf16_nodes,
)
from pathtracing_tpu_torch.scene.loader import load_scene, setup_animation_frame
from pathtracing_tpu_torch.scene.standins import write_standins
from pathtracing_tpu_torch.scene.golden import (
    scene_device_from_golden,
    scene_device_from_motion_golden,
)
from pathtracing_tpu_torch.utils import native_build
from pathtracing_tpu_torch.utils.goldenio import load_golden
from pathtracing_tpu_torch.utils.vec import Vec3


ROOT = pathlib.Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "golden"
MAIN_SPP = 8  # PRODUCTION asks for 1024; cut so the run fits its time limit
MAIN_LAYOUT = "w8"  # the wide main path's layout (pack_scene's default)
LAYOUTS = {"w8": LAYOUT_W8, "w16": LAYOUT_W16, "s8": LAYOUT_S8}

# Published peaks of one H100 SXM (NVIDIA data sheet): device memory rate
# and float32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
# Row bytes of the tables (a node row counts as the 32 B sectors it spans:
# one for nl8, one or two for nl5), and flops per visit (counted from the
# source: slab test 27, triangle test 52, BLAS entry 45).
TRI_ROW_B, INST_ROW_B = 48, 84 + 24
SECTOR_B = 32  # the unit of a device-memory and L2 transfer
NODE_FLOPS, TRI_FLOPS, INST_FLOPS = 27, 52, 45
# The megakernel's float operations per call of each piece of its device code
# (csrc/shading.cuh, csrc/megakernel.cu), counted from the source: every
# float add, subtract, multiply, divide, square root and transcendental is
# one, comparisons and selects none; the RNG's integer operations are left
# out (so the bound stays a lower bound). Keyed by the counting build's
# counters (ops/cuda_megakernel.COUNT_NAMES); the walk's visits are charged
# as above (slab tests, triangle tests, BLAS entries).
MK_FLOPS = {
    "samples": 85,        # film draw, Gaussian disk, camera ray
    "rays": 3,            # reciprocal direction of each walk
    "shade_hits": 241,    # instance ray, triangle test, 10 attributes, normal,
                          # tangent space, position + the path update after it
    "shade_misses": 95,   # sun disk, tangent space, position + path update
    "atmo_marches": 1590,  # 8 primary x 4 secondary steps, phases, in-scatter
    "nee_evals": 236,     # cone sample, tangent space, bsdf_eval
    "nee_marches": 268,   # MIS weight + the 8-step transmittance march
    "bsdf_samples": 244,  # view, GGX VNDF, lobe pick, bsdf_core, new direction
    # area lights: the CDF pick 1, barycentrics 5, the point 15, toward it 12,
    # its solid-angle pdf 30, the emission 23, tangent space 15, bsdf_eval
    # ~180, the MIS weight 4, the term 6 and its add 6
    "light_samples": 297,
    "light_pdfs": 30,     # a closest hit's solid-angle pdf on an emitter
}
# wide_ray_query's registers per layout and ray_query's (and 0 spill bytes
# each) as the kernels compiled before their walks moved into wide_walk.cuh
# and binary_walk.cuh
K1_REGISTERS = {"w8": 80, "w16": 91, "s8": 67}
P1_REGISTERS = 52
# the path kernels' timed builds per design and table kind, (registers,
# spill bytes): K2's first design as it was first built (the record build K6
# and the phase-cycle build are kernels of their own), its wide block (512
# threads a block: at most 128 registers), and K5's
K2_TIMED = {
    "first": {"w8": (128, 0), "w16": (128, 172), "s8": (126, 0)},
    "wide": {"w8": (128, 0), "w16": (128, 36), "s8": (126, 0)},
}
K5_TIMED = {
    "first": {"binary": (115, 0), "w8": (128, 0), "w16": (128, 172), "s8": (126, 0)},
    "wide": {"binary": (116, 0), "w8": (128, 0), "w16": (128, 0), "s8": (126, 0)},
}

RTOL = ATOL = 1e-6  # kernel vs plain version: same ops, same order, no FMA
# Shared memory a block could give to staged mega-table rows: the share of
# row visits the hottest rows of this size carry is printed per batch.
HOT_ROW_BYTES = 160 * 1024
EDGE_R = (1, 31, 33, 4097)  # one lane, just under / over a warp, a ragged block

LIBRARIES = {"ray_query": CT.LIBRARY, "wide_ray_query": CW.LIBRARY,
             "gather_rows": GP.LIBRARY, "megakernel": CM.LIBRARY,
             "wavefront": CWF.LIBRARY, "gather_grad": CG.LIBRARY, "denoise": CD.LIBRARY,
             # the path kernels' area-light instances: the same sources, built
             # side by side as libraries of their own
             "megakernel_lit": CM.LIT_LIBRARY, "wavefront_lit": CWF.LIT_LIBRARY,
             # the instances that walk the bf16 node rows (nl5): P1's, and
             # K5's binary walk, sun-only and area-light
             "ray_query_nl5": CT.NL5_LIBRARY, "wavefront_nl5": CWF.NL5_LIBRARY,
             "wavefront_nl5_lit": CWF.NL5_LIT_LIBRARY}
SOURCES = {k: str(lib.source.relative_to(ROOT)) for k, lib in LIBRARIES.items()}


def require(cond, what) -> None:
    """A check that survives ``python -O``."""
    if not cond:
        raise AssertionError(str(what))


T_START = time.perf_counter()


def emit(phase: str, **kw) -> None:
    """One phase's JSON line, with the run's seconds so far (``t``)."""
    print(json.dumps({"phase": phase, "t": round(time.perf_counter() - T_START, 1), **kw}),
          flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


# ----------------------------------------------------------------- comparing


def compare_hits(tag, hk, ok, hp, op):
    """Kernel result vs plain version's: ids equal, floats within RTOL/ATOL.
    Returns the max abs error over thit/u/v; raises with the counts if not."""
    bad = {
        "occluded": int((ok != op).sum()),
        "inst": int((hk.inst != hp.inst).sum()),
        "prim": int((hk.prim != hp.prim).sum()),
        "back": int((hk.back != hp.back).sum()),
    }
    err = 0.0
    for name in ("thit", "bary_u", "bary_v"):
        a, b = getattr(hk, name), getattr(hp, name)
        close = torch.isclose(a, b, rtol=RTOL, atol=ATOL)
        bad[name] = int((~close).sum())
        err = max(err, float((a - b).abs().max()))
    if any(bad.values()):
        raise AssertionError(f"{tag}: kernel disagrees with plain version: {bad}")
    return err


def check_oracle(rays_g, hit, occluded_anyhit):
    """tests/test_traversal.py's bars against the oracle columns."""
    thit = hit.thit.cpu().numpy()
    miss_ref = rays_g["thit"] < 0
    np.testing.assert_array_equal(thit < 0, miss_ref)
    h = ~miss_ref
    np.testing.assert_allclose(thit[h], rays_g["thit"][h], rtol=2e-5, atol=1e-5)
    same = (hit.inst.cpu().numpy() == rays_g["inst"].view(np.int32)) & (
        hit.prim.cpu().numpy() == rays_g["prim"].view(np.int32)
    )
    diff = h & ~same
    require(diff.mean() <= 0.002, f"{diff.sum()} id mismatches vs oracle")
    exact = h & same
    np.testing.assert_array_equal(
        hit.back.cpu().numpy()[exact].astype(np.uint32), rays_g["back"][exact]
    )
    for k, col in (("bary_u", 0), ("bary_v", 1)):
        np.testing.assert_allclose(
            getattr(hit, k).cpu().numpy()[exact], rays_g["bary"][exact, col],
            rtol=2e-5, atol=2e-6,
        )
    np.testing.assert_array_equal(
        occluded_anyhit.cpu().numpy().astype(np.uint32), rays_g["occluded"]
    )
    return int(diff.sum())


def id_mismatches(tag, ha, oa, hb, ob) -> int:
    """Two walks of the same rays (wide vs binary kernel): hit/miss and
    ``occluded`` equal; hit ids may differ only where two triangles are hit at
    exactly equal t, on at most 0.2 % of the rays; thit equal where ids are."""
    require(bool(torch.equal(oa, ob)), f"{tag}: occluded differs")
    require(bool(torch.equal(ha.thit < 0, hb.thit < 0)), f"{tag}: hit/miss differs")
    same = (ha.inst == hb.inst) & (ha.prim == hb.prim)
    n_diff = int((~same).sum())
    require(n_diff <= 0.002 * same.numel(), f"{tag}: {n_diff} id mismatches")
    require(bool(torch.equal(ha.thit, hb.thit)), f"{tag}: thit differs")
    for k in ("bary_u", "bary_v", "back"):
        require(bool(torch.equal(getattr(ha, k)[same], getattr(hb, k)[same])),
                f"{tag}: {k} differs where ids agree")
    return n_diff


# -------------------------------------------------------------------- timing


def time_launches(fns: dict, reps=5) -> dict:
    """Median ms of one call of each function, L2 flushed before each call
    (between two queries of a frame the shading pass streams far more than
    the 50 MB L2), the functions taking turns within every repetition."""
    flush = torch.empty(256 << 20, dtype=torch.int8, device="cuda")
    for fn in fns.values():
        fn()  # warm-up
    ms = {k: [] for k in fns}
    for rep in range(reps):
        order = list(fns) if rep % 2 == 0 else list(fns)[::-1]
        for k in order:
            flush.zero_()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fns[k]()
            b.record()
            torch.cuda.synchronize()
            ms[k].append(a.elapsed_time(b))
    return {k: (float(np.median(v)), v) for k, v in ms.items()}


def ray_io_bytes(anyhit, tmax0, rays: int, active: int, handles: int = 8,
                 tmin=0.0) -> int:
    """Bytes the function must move for this batch's rays: every lane's
    ``active`` byte in and its seven outputs out; the ray itself only for an
    active lane (an inactive lane's result does not depend on it).
    ``handles``: bytes of TLAS handles a lane's walk reads (count and offset
    for the binary walk, the offset alone for the wide one)."""
    every = 1 + 3 * 4 + 2 * 4 + 2  # active; thit,u,v + inst,prim + back,occluded
    ray = handles + 24  # TLAS handles, org+dir
    ray += 1 if isinstance(anyhit, torch.Tensor) else 0
    ray += 4 if isinstance(tmax0, torch.Tensor) and tmax0.dim() else 0
    ray += 4 if isinstance(tmin, torch.Tensor) and tmin.dim() else 0
    return rays * every + active * ray


def bound(table_b: int, io_b: int, row_b: int, flops: int) -> dict:
    """The least time the card could take: each input read once and each
    output written once at the card's memory rate, against this batch's flops
    (from the counted row visits) at its float32 rate. The row reads a walk
    makes are many times the tables' size, but the tables sit in L2, so
    re-reads are not traffic the card must pay for; their cost at
    device-memory rate is reported beside the bound, not as the bound."""
    by_bytes = (table_b + io_b) / HBM_BYTES_PER_S * 1e3
    by_ops = flops / FP32_FLOPS * 1e3
    return {
        "bound_ms": max(by_bytes, by_ops),
        "bound_by": "bytes" if by_bytes >= by_ops else "operations",
        "bound_bytes_ms": by_bytes, "bound_ops_ms": by_ops,
        "row_reads_at_hbm_rate_ms": (row_b + io_b) / HBM_BYTES_PER_S * 1e3,
    }


def measure_shape(tag, args, kwargs):
    """One main-path batch of the binary walk: kernel vs plain, times,
    counts, bound."""
    R = args[3].x.shape[0]
    hk, ok = ray_query(*args, **kwargs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    # this batch's row reads, counted by the plain version as it walks
    hp, op, c = ray_query_plain(*args, **kwargs, return_counts=True)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = compare_hits(tag, hk, ok, hp, op)

    ms, all_ms = time_launches({"k": lambda: ray_query(*args, **kwargs)})["k"]

    n_active = int(args[7].sum())
    io_b = ray_io_bytes(kwargs.get("anyhit", False), args[6], R, n_active)
    node, inst, tri = c.node_rows, c.inst_rows, c.tri_rows
    # the wavefront kernel abandons a sample whose ray walks past the step
    # cap derived from the tables
    longest, cap = int(c.lane_steps.max()), CM.step_cap(args[0])
    require(cap >= 16 * longest, f"step cap {cap} vs longest walk {longest}")
    # each table row the batch's walk touched, read once (the finalize
    # step's instance and triangle rows included); node rows as the 32 B
    # sectors they span (an nl8 row is one, an nl5 row one or two)
    table_b = (c.node_sectors_touched * SECTOR_B + c.inst_rows_touched * INST_ROW_B
               + c.tri_rows_touched * TRI_ROW_B)
    b = bound(
        table_b, io_b,
        c.node_sectors * SECTOR_B + tri * TRI_ROW_B + inst * INST_ROW_B,
        node * NODE_FLOPS + tri * TRI_FLOPS + inst * INST_FLOPS,
    )
    return {
        "shape": tag, "rays": R, "active": n_active, "io_bytes": io_b,
        "longest_walk_rows": longest, "path_kernels_step_cap": cap,
        "table_bytes_needed": table_b, "max_abs_err": err, "ms": ms,
        "ms_all": all_ms, "plain_ms": plain_ms, **scalars(c),
        **walk_stats(c.lane_steps, args[7]),
        **b, "roofline_share": b["bound_ms"] / ms,
    }


def check_wide_batch(tag, args, kwargs):
    """One main-path batch through the wide kernel, its plain version (which
    counts this batch's row visits) and the binary kernel (the wide scene
    carries the binary tables too). Returns the kernel's result, the plain
    version's counts and time, and the comparisons' outcomes."""
    hk, ok = CW.wide_ray_query_cuda(*args, **kwargs)
    hb, ob = CT.ray_query_cuda(*args, **kwargs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hp, op, c = wide_ray_query_plain(*args, **kwargs, return_counts=True)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = compare_hits(tag, hk, ok, hp, op)
    ties = id_mismatches(tag + " vs ray_query", hk, ok, hb, ob)
    return hk, c, plain_ms, err, ties


def wide_table_bytes_needed(scene, lay, args, hit, c) -> int:
    """Bytes of tables this batch's walk must read at least once: the
    mega-table rows it visited, the root-cursor rows of its active lanes'
    TLAS offsets, and for the finalize step one ``inst_f`` + ``inst_u`` row
    per distinct instance hit and one ``tri_pos`` row per distinct triangle
    hit. (A stub layout also reads ``tri_pos`` for its leaf tests; no
    main-path batch runs one, so that term is not counted here.)"""
    require(not lay.stub, "the bound is worked out for non-stub layouts")
    roots = int(torch.unique(args[2][args[7]]).numel())
    h = hit.inst >= 0
    inst = hit.inst[h].long()
    tri = scene.inst_u[inst, 4] + hit.prim[h]  # the instance's triangle base
    return (c.rows_touched * lay.w_row * 4 + roots * 8 * 4
            + int(torch.unique(inst).numel()) * INST_ROW_B
            + int(torch.unique(tri).numel()) * TRI_ROW_B)


def scalars(counts) -> dict:
    """A counts tuple's numbers (its per-lane and per-row tensors left out)."""
    return {k: v for k, v in counts._asdict().items() if not isinstance(v, torch.Tensor)}


def walk_stats(lane_steps, active, row_visits=None, row_bytes=0) -> dict:
    """How a batch fills the card's SIMD lanes: ``simd_efficiency`` of the
    plain version's steps per lane, in launch order and with the active lanes
    packed first; the share of 32-lane warps that hold an active lane; and
    for the wide walk the share of row visits that fall on the hottest rows
    fitting in HOT_ROW_BYTES."""
    in_order, packed = simd_efficiency(lane_steps)
    pad = (-active.numel()) % 32
    warps = torch.cat([active, active.new_zeros(pad)]).view(-1, 32).any(dim=1)
    out = {"simd_efficiency": in_order, "simd_efficiency_packed": packed,
           "active_warp_share": float(warps.float().mean())}
    if row_visits is not None:
        hot = HOT_ROW_BYTES // row_bytes
        v = row_visits.sort(descending=True).values
        out.update(hot_rows=hot, hot_row_visit_share=float(v[:hot].sum()) / float(v.sum()))
    return out


def measure_wide_shape(tag, args, kwargs):
    """One main-path batch of the wide walk: kernel vs plain, its time beside
    the binary kernel's on the same batch, counts, bound."""
    scene = args[0]
    lay = LAYOUTS_BY_WIDTH[scene.wide_rows.shape[1]]
    R = args[3].x.shape[0]
    hk, c, plain_ms, err, ties = check_wide_batch(tag, args, kwargs)

    t = time_launches({
        "wide": lambda: CW.wide_ray_query_cuda(*args, **kwargs),
        "binary": lambda: CT.ray_query_cuda(*args, **kwargs),
    })

    n_active = int(args[7].sum())
    io_b = ray_io_bytes(kwargs.get("anyhit", False), args[6], R, n_active,
                        handles=4, tmin=args[5])
    S, L = lay.n_slots, lay.leaf_tris
    finalize = c.hits * (INST_ROW_B + TRI_ROW_B)
    row_b = (c.wide_rows * (4 * S + 1) * 4 + c.leaf_rows * (10 * L + 1) * 4
             + c.inst_rows * 21 * 4 + finalize)
    # slab tests the walk needs (slots from the cursor's start slot on whose
    # link is not the empty one), not S per WIDE visit
    flops = (c.slab_tests * NODE_FLOPS + c.tri_tests * TRI_FLOPS
             + c.inst_rows * INST_FLOPS + c.hits * (INST_FLOPS + TRI_FLOPS))
    table_b = wide_table_bytes_needed(scene, lay, args, hk, c)
    b = bound(table_b, io_b, row_b, flops)
    ms, all_ms = t["wide"]
    # the path kernels abandon a sample whose ray walks past the step cap
    # derived from the tables
    longest = int(c.lane_steps.max())
    cap = CM.step_cap(scene)
    require(cap >= 16 * longest, f"step cap {cap} vs longest walk {longest}")
    return {
        "shape": tag, "layout": MAIN_LAYOUT, "rays": R, "active": n_active,
        "longest_walk_rows": longest, "path_kernels_step_cap": cap,
        "io_bytes": io_b, "table_bytes_needed": table_b, "flops": flops,
        "max_abs_err": err, "ms": ms, "ms_all": all_ms,
        "p1_ms_same_batch": t["binary"][0], "p1_ms_all": t["binary"][1],
        "id_mismatches_vs_ray_query": ties, "plain_ms": plain_ms,
        **scalars(c), **walk_stats(c.lane_steps, args[7], c.row_visits, lay.w_row * 4),
        **b, "roofline_share": b["bound_ms"] / ms,
    }


def tile_pixels(scene) -> int:
    """The scan's and the wavefront's tile on the card for this scene: the
    tuning table's row for "cuda" and the scene's size
    (render.default_tile_pixels), what render_pixels takes."""
    return default_tile_pixels(scene, "cuda")


def main_path_tile_lanes(cfg, scene) -> int:
    """Lanes of the first (largest) tile of the main path's frame."""
    return min(tile_pixels(scene), cfg.image_width * cfg.image_height)


def capture_queries(cfg, scene, xs, ys):
    """The arguments ``path_trace_samples`` hands to ``ray_query`` for one
    sample of the pixels (xs, ys): [primary, bounce 1, ...]."""
    calls = []
    orig = integrator.ray_query

    def spy(*a, **k):
        calls.append((a, k))
        return orig(*a, **k)

    integrator.ray_query = spy
    try:
        integrator.path_trace_samples(cfg, scene, xs, ys, torch.zeros_like(xs))
    finally:
        integrator.ray_query = orig
    torch.cuda.synchronize()
    return calls


def capture_main_path_queries(cfg, scene, n):
    """The same for one tile of n pixels of the frame: [primary, bounce 1,
    ...]."""
    idx = torch.arange(n, dtype=torch.int32, device="cuda")
    return capture_queries(cfg, scene, idx % cfg.image_width, idx // cfg.image_width)


# -------------------------------------------------------------------- phases


# (slots, leaf triangles, stub) of each layout as they appear in a kernel's
# mangled template arguments
LAYOUT_MANGLED = {"w8": "ILi8ELi4ELb0E", "w16": "ILi16ELi8ELb0E", "s8": "ILi8ELi8ELb1E"}


def by_layout(kernels) -> dict:
    """ptxas' report of a layout-templated kernel per layout: {layout:
    (registers, spill bytes)}."""
    out = {}
    for name, tag in LAYOUT_MANGLED.items():
        hit = [k for k in kernels if tag in k["entry"]]
        require(len(hit) == 1, f"{name}: {len(hit)} kernels match {tag}")
        k = hit[0]
        out[name] = (k["registers"], k["spill_store_bytes"] + k["spill_load_bytes"])
    return out


# the wavefront kernel's walk policy per table kind, as mangled in its name
WALK_MANGLED = {"binary": "10BinaryWalk", **{k: "8WideWalk" + v for k, v in LAYOUT_MANGLED.items()}}
# the path kernels' builds: (kernel, threads a block, count policy as
# mangled, light policy as mangled; "" for none: the record build has no
# light policy); the area-light instances (csrc/path.cuh, AreaLights) are
# the lit_* builds
SUN, LIT = "12NoAreaLights", "10AreaLights"
MK_BUILDS = {
    "first": ("megakernel", 128, "11NoPathCount", SUN),
    "wide": ("megakernel", 512, "11NoPathCount", SUN),
    "counting": ("megakernel", 128, "9PathCount", SUN),
    "phases_first": ("megakernel", 128, "10PhaseClock", SUN),
    "phases_wide": ("megakernel", 512, "10PhaseClock", SUN),
    "record_first": ("megakernel_record", 128, "", ""),
    "record_wide": ("megakernel_record", 512, "", ""),
    "lit_first": ("megakernel", 128, "11NoPathCount", LIT),
    "lit_wide": ("megakernel", 512, "11NoPathCount", LIT),
    "lit_counting": ("megakernel", 128, "9PathCount", LIT),
}
WF_BUILDS = {k: ("wavefront", *v[1:]) for k, v in MK_BUILDS.items() if "record" not in k}
# the megakernel's layout arguments follow its first two template arguments
MK_LAYOUT_TAGS = {k: v[1:] for k, v in LAYOUT_MANGLED.items()}


def path_builds(kernels, builds, tags) -> dict:
    """ptxas' report of a path kernel per build and table kind: {build:
    {kind: (registers, spill bytes)}}; a kernel is picked by its name and
    first template argument as mangled (length, name, threads), its table
    kind's tag, its count policy and its light policy."""
    out = {}
    for build, (name, threads, count, lights) in builds.items():
        out[build] = {}
        head = f"{len(name)}{name}ILi{threads}E"
        for kind, tag in tags.items():
            hit = [k for k in kernels if head in k["entry"]
                   and tag in k["entry"] and count in k["entry"] and lights in k["entry"]]
            require(len(hit) == 1, f"{name} {build} {kind}: {len(hit)} kernels match "
                                   f"{head} {tag} {count} in {[k['entry'] for k in kernels]}")
            k = hit[0]
            out[build][kind] = (k["registers"], k["spill_store_bytes"] + k["spill_load_bytes"])
    return out


def p1_kernels(kernels) -> dict:
    """{"query": (registers, spill bytes), "bounded": ...} of a ray_query
    library's two kernels, picked by entry name; raises unless there are
    exactly those two."""
    out = {}
    for k in kernels:
        kind = ("bounded" if "ray_query_bounded_kernel" in k["entry"]
                else "query" if "ray_query_kernel" in k["entry"] else k["entry"])
        out[kind] = (k["registers"], k["spill_store_bytes"] + k["spill_load_bytes"])
    require(sorted(out) == ["bounded", "query"], f"ray_query kernels {sorted(out)}")
    return out


def phase_build(early=None):
    """All twelve libraries, one nvcc each, started together. ``early``:
    (library names, fn): fn runs in this thread as soon as those libraries
    are built, while the others still build (the path kernels' libraries
    take the longest). The build's seconds run from the start to the last
    library built."""
    t0 = time.perf_counter()
    done_at = {}
    with ThreadPoolExecutor(len(LIBRARIES)) as pool:
        futures = {}
        for name, lib in LIBRARIES.items():
            futures[name] = pool.submit(lib.build)
            futures[name].add_done_callback(
                lambda f, name=name: done_at.__setitem__(name, time.perf_counter()))
        if early is not None:
            names, fn = early
            for name in names:
                futures[name].result()
            fn()
        for f in futures.values():
            f.result()
    sec = max(done_at.values()) - t0
    report = {}
    for name, lib in LIBRARIES.items():
        res = lib.resources()
        require(res, f"{name}: no ptxas report in {lib.build_log}")
        report[name] = {"source": SOURCES[name], "seconds": lib.build_seconds,
                        "kernels": res}
    # the ray-query kernels: blocks of block_size() threads one SM holds at
    # once (registers decide)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    occ = {"ray_query": CT.LIBRARY.load().pt_ray_query_occupancy(),
           "ray_query_nl5": CT.NL5_LIBRARY.load().pt_ray_query_occupancy()}
    for name, lay in LAYOUTS.items():
        occ[name] = CW.LIBRARY.load().pt_wide_ray_query_occupancy(lay.w_row)
    # the path kernels' first design (both designs' are in design_timing)
    mk_occ = {name: CM.LIBRARY.load().pt_megakernel_occupancy(lay.w_row, 0)
              for name, lay in LAYOUTS.items()}
    wf_occ = {name: CWF.LIBRARY.load().pt_wavefront_occupancy(w, 0)
              for name, w in (("binary", 0), *((k, v.w_row) for k, v in LAYOUTS.items()))}
    # the area-light instances in the design each table kind takes
    lit_occ = {"megakernel_w8": CM.LIT_LIBRARY.load().pt_megakernel_occupancy(
                   LAYOUT_W8.w_row, CM.design_code(LAYOUT_W8.w_row, None)),
               **{f"wavefront_{name}": CWF.LIT_LIBRARY.load().pt_wavefront_occupancy(
                   w, CM.design_code(w, None))
                  for name, w in (("binary", 0), ("w8", LAYOUT_W8.w_row))}}
    # the nl5 instances of K5 (binary walk only) in the binary design
    nl5_occ = {name: lib.load().pt_wavefront_occupancy(0, CM.design_code(0, None))
               for name, lib in (("wavefront_nl5", CWF.NL5_LIBRARY),
                                 ("wavefront_nl5_lit", CWF.NL5_LIT_LIBRARY))}
    require(all(v > 0 for v in [*occ.values(), *mk_occ.values(), *wf_occ.values(),
                                *lit_occ.values(), *nl5_occ.values()]),
            f"occupancy query failed: {occ} {mk_occ} {wf_occ} {lit_occ} {nl5_occ}")
    # a library of nl5 rows has no wide instance
    require(CWF.NL5_LIBRARY.load().pt_wavefront_occupancy(LAYOUT_W8.w_row, 0) == 0,
            "wavefront_nl5 has a wide instance")
    words = {name: (LIBRARIES[name].load().pt_ray_query_node_words() if "ray" in name
                    else LIBRARIES[name].load().pt_wavefront_node_words())
             for name in ("ray_query", "ray_query_nl5", "wavefront", "wavefront_lit",
                          "wavefront_nl5", "wavefront_nl5_lit")}
    require(words == {k: 5 if "nl5" in k else 8 for k in words},
            f"node-row words per library {words}")
    report["ray_query"]["blocks_per_sm"] = occ["ray_query"]
    report["ray_query_nl5"]["blocks_per_sm"] = occ["ray_query_nl5"]
    report["wide_ray_query"]["blocks_per_sm"] = {k: occ[k] for k in LAYOUTS}
    report["megakernel"]["blocks_per_sm"] = mk_occ
    report["wavefront"]["blocks_per_sm"] = wf_occ
    report["area_light_blocks_per_sm"] = lit_occ
    report["nl5_blocks_per_sm"] = nl5_occ
    # the walks moved into wide_walk.cuh and binary_walk.cuh: K1 and P1
    # compile as they did before
    k1 = by_layout(report["wide_ray_query"]["kernels"])
    require(k1 == {k: (v, 0) for k, v in K1_REGISTERS.items()},
            f"wide_ray_query registers/spills {k1}, expected {K1_REGISTERS} / 0")
    report["wide_ray_query"]["registers_spills_by_layout"] = k1
    # P1's two kernels per library: the query, and the bounded query (its own
    # kernel, so the query compiles as before)
    p1 = p1_kernels(report["ray_query"]["kernels"])
    require(p1["query"] == (P1_REGISTERS, 0),
            f"ray_query registers/spills {p1}, expected {P1_REGISTERS} / 0")
    p1_nl5 = p1_kernels(report["ray_query_nl5"]["kernels"])
    require(p1_nl5["query"][1] == 0 and p1_nl5["bounded"][1] == 0 and p1["bounded"][1] == 0,
            f"ray_query registers/spills {p1}, nl5 {p1_nl5}: spills")
    report["ray_query"]["registers_spills"] = p1
    report["ray_query_nl5"]["registers_spills"] = p1_nl5["query"]
    report["ray_query_nl5"]["registers_spills_bounded"] = p1_nl5["bounded"]
    wf = path_builds(report["wavefront"]["kernels"] + report["wavefront_lit"]["kernels"],
                     WF_BUILDS, WALK_MANGLED)
    mk = path_builds(report["megakernel"]["kernels"] + report["megakernel_lit"]["kernels"],
                     MK_BUILDS, MK_LAYOUT_TAGS)
    report["wavefront"]["registers_spills_by_layout"] = wf
    report["megakernel"]["registers_spills_by_layout"] = mk
    # K5's nl5 instances: each build the nl8 binary walk has, on nl5 rows
    report["wavefront_nl5"]["registers_spills_by_layout"] = path_builds(
        report["wavefront_nl5"]["kernels"] + report["wavefront_nl5_lit"]["kernels"],
        WF_BUILDS, {"binary_nl5": "7Nl5Rows"})
    # the instruments (counting, phase-cycle and record builds) are kernels
    # of their own: the timed builds compile as recorded
    k2 = {d: mk[d] for d in K2_TIMED}
    require(k2 == K2_TIMED, f"megakernel timed builds {k2}, expected {K2_TIMED}")
    k5 = {d: wf[d] for d in K5_TIMED}
    require(k5 == K5_TIMED, f"wavefront timed builds {k5}, expected {K5_TIMED}")
    mk_block, wf_block = CM.block_size(), CWF.block_size()
    emit("build", seconds=sec, flags=list(cuda_build.NVCC_FLAGS), libraries=report,
         sms=sms, block=CT.block_size(), megakernel_block=mk_block, wavefront_block=wf_block,
         resident_warps_per_sm={k: v * CT.block_size() // 32 for k, v in occ.items()},
         megakernel_resident_warps_per_sm={k: v * mk_block // 32 for k, v in mk_occ.items()},
         wavefront_resident_warps_per_sm={k: v * wf_block // 32 for k, v in wf_occ.items()},
         wide_block=CM.block_size("wide"),
         wide_ray_query_registers_unchanged=True, ray_query_registers_unchanged=True,
         path_kernel_timed_registers_as_recorded=True)
    return report


def rays_gold_inputs(scene_g, rays_g, dev, R=4096):
    """rays.gold's 4096 rays (repeated to R lanes) and the lane masks."""
    full = lambda v: torch.full((R,), int(v), dtype=torch.int32, device=dev)
    col = lambda a, i: torch.from_numpy(np.ascontiguousarray(np.resize(a, (R, 3))[:, i])).to(dev)
    rs = np.random.default_rng(7)
    lane = lambda a: torch.from_numpy(a).to(dev)
    return {
        "R": R,
        "tlc": full(scene_g["tlas"][0]), "tlo": full(scene_g["tlas"][1]),
        "org": Vec3(*(col(rays_g["origins"], i) for i in range(3))),
        "d": Vec3(*(col(rays_g["dirs"], i) for i in range(3))),
        "on": torch.ones(R, dtype=torch.bool, device=dev),
        "mask": lane(rs.random(R) < 0.5),
        "some": lane(rs.random(R) < 0.7),
        "tmax_lane": lane(rs.uniform(0.5, 40.0, R).astype(np.float32)),
        "tmin_lane": lane(rs.uniform(0.0, 2.0, R).astype(np.float32)),
    }


def run_modes(scene, inp, kernel_fn, plain_fn, per_lane_tmin: bool):
    """The kernel against its plain version on the rays of rays.gold in every
    mode; returns ({mode: max abs err}, {mode: (hit, occluded)} of the kernel)."""
    R = inp["R"]

    def both(tag, n, tmin, tmax0, active, anyhit):
        cut = lambda t: t[:n].contiguous() if isinstance(t, torch.Tensor) and t.dim() else t
        a = (scene, cut(inp["tlc"]), cut(inp["tlo"]), Vec3(*map(cut, inp["org"])),
             Vec3(*map(cut, inp["d"])), cut(tmin), cut(tmax0), cut(active))
        hk, ok = kernel_fn(*a, anyhit=cut(anyhit))
        torch.cuda.synchronize()
        hp, op = plain_fn(*a, anyhit=cut(anyhit))
        return compare_hits(tag, hk, ok, hp, op), (hk, ok)

    on, mask, some = inp["on"], inp["mask"], inp["some"]
    modes = {
        "closest": (R, 0.0, 1e9, on, False),
        "anyhit": (R, 1e-4, 1e9, on, True),
        "mixed_mask": (R, 1e-4, 1e9, on, mask),
        "inactive_lanes": (R, 0.0, 1e9, some, mask),
        # R not a multiple of the block, per-lane tmax0
        "ragged_tmax_lane": (R - 37, 1e-4, inp["tmax_lane"], some, mask),
    }
    if per_lane_tmin:
        modes["tmin_lane"] = (R - 37, inp["tmin_lane"], inp["tmax_lane"], some, mask)
    errs, out = {}, {}
    for tag, m in modes.items():
        errs[tag], out[tag] = both(tag, *m)
    hit_i, occ_i = out["inactive_lanes"]
    require(bool((hit_i.thit[~some] == -1).all()) and not bool(occ_i[~some].any()),
            "inactive lanes traced")
    return errs, out


def run_edge_modes(scene, scene_g, rays_g, kernel_fn, plain_fn, tag):
    """A launch's edge cases, each bit-equal to the plain version (closest
    and any-hit lanes mixed): batches of EDGE_R lanes; every lane inactive;
    every lane active; active lanes only in the last warp of 32; and two
    launches in a row on one wrapper. Returns {mode: max abs err}."""
    dev = scene.nl8.device
    inp = rays_gold_inputs(scene_g, rays_g, dev, max(EDGE_R))
    R = 4096
    last = torch.zeros(max(EDGE_R), dtype=torch.bool, device=dev)
    last[R - 32 + 3:R] = True
    cases = {f"R={n}": (n, inp["some"]) for n in EDGE_R}
    cases["all_inactive"] = (R, torch.zeros_like(last))
    cases["all_active"] = (R, torch.ones_like(last))
    cases["last_warp_only"] = (R, last)

    def lanes(n, active):
        cut = lambda t: t[:n].contiguous()
        return ((scene, cut(inp["tlc"]), cut(inp["tlo"]), Vec3(*map(cut, inp["org"])),
                 Vec3(*map(cut, inp["d"])), 1e-4, 1e9, cut(active)), cut(inp["mask"]))

    errs = {}
    for name, (n, active) in cases.items():
        a, mask = lanes(n, active)
        hk, ok = kernel_fn(*a, anyhit=mask)
        torch.cuda.synchronize()
        hp, op = plain_fn(*a, anyhit=mask)
        errs[name] = compare_hits(f"{tag} {name}", hk, ok, hp, op)
    a, mask = lanes(max(EDGE_R), inp["some"])
    first = kernel_fn(*a, anyhit=mask)
    second = kernel_fn(*a, anyhit=mask)
    torch.cuda.synchronize()
    hp, op = plain_fn(*a, anyhit=mask)
    errs["two_launches"] = max(compare_hits(f"{tag} launch {i}", *hk, hp, op)
                               for i, hk in enumerate((first, second)))
    return errs


def phase_kernel_check(scene_g, rays_g, scene, prod_cfg, prod_scene):
    inp = rays_gold_inputs(scene_g, rays_g, scene.nl8.device)
    R = inp["R"]
    errs, out = run_modes(scene, inp, ray_query, ray_query_plain, per_lane_tmin=False)
    require((R - 37) % CT.block_size() != 0, "ragged batch is a block multiple")
    id_ties = check_oracle(rays_g, out["closest"][0], out["anyhit"][1])
    emit("kernel_check", part="rays.gold", rays=R, modes=list(errs),
         max_abs_err=max(errs.values()), rtol=RTOL, atol=ATOL,
         oracle_id_mismatches=id_ties, ids="equal")
    edge = run_edge_modes(scene, scene_g, rays_g, ray_query, ray_query_plain, "ray_query")
    emit("kernel_check", part="edge_modes", modes=list(edge),
         max_abs_err=max(edge.values()), ids="equal")
    errs.update(edge)

    lanes = main_path_tile_lanes(prod_cfg, prod_scene)
    calls = capture_main_path_queries(prod_cfg, prod_scene, lanes)
    require(len(calls) == 1 + prod_cfg.max_bounces, f"{len(calls)} ray queries per sample")
    shapes = [
        measure_shape("primary", *calls[0]),
        measure_shape("bounce", *calls[1]),
    ]
    require(shapes[1]["rays"] == 2 * lanes, "bounce batch is not 2 x tile")
    require(shapes[1]["active"] < shapes[1]["rays"], "bounce batch holds no inactive lane")
    for s in shapes:
        emit("kernel_check", part="main_path_shape", **s)
    bounded = phase_bounded_walk(prod_scene, *calls[1], shapes[1])
    return (max(max(errs.values()), *(s["max_abs_err"] for s in shapes)), shapes, out,
            bounded)


BOUNDED_STEPS = (8, 64)  # the bounded P1's max_steps, beside the longest lane's steps


def bits(t):
    """A tensor compared bit for bit: f32 as its int32 words."""
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def state_bits_differ(a, b) -> list:
    """The _TravState fields of two walk states that differ in any bit."""
    return [f for f in _TravState._fields
            if not torch.equal(bits(getattr(a, f)), bits(getattr(b, f)))]


def completion_steps(args, kwargs):
    """Each lane's steps to done by the bounded query, read as
    tools/stress_probe.py reads them: max_steps doubled until every lane is
    done, a lane's step the first bound at which it is (an upper bound);
    then the longest lane's steps, exactly, by bisection. Every call goes
    through ray_query with return_state=True. Returns (steps per lane,
    longest, calls)."""
    R = args[3].x.shape[0]
    done_at = torch.full((R,), -1, dtype=torch.int32, device="cuda")
    k, calls = 1, 0
    while True:
        done = ray_query(*args, **kwargs, max_steps=k, return_state=True).done
        calls += 1
        done_at[done & (done_at < 0)] = k
        if bool(done.all()):
            break
        k *= 2
    lo, hi = k // 2, k
    while hi - lo > 1:
        mid = (lo + hi) // 2
        calls += 1
        if bool(ray_query(*args, **kwargs, max_steps=mid, return_state=True).done.all()):
            hi = mid
        else:
            lo = mid
    return done_at, hi, calls


def phase_bounded_walk(scene, args, kwargs, bounce):
    """P1's bounded query (ray_query(max_steps=, return_state=)) on the
    golden main path's bounce batch, on nl8 and nl5 rows: the lanes'
    completion steps swept through ray_query (the launches counted from 0
    over that sweep, the path this drives); at max_steps 8, 64 and the
    longest lane's steps the kernel's walk state bit-equal to the plain
    version's on every field; at the longest lane's steps its hits bit-equal
    to the unbounded P1's; the bounded state launch timed beside the
    unbounded query, with its bound (nl8: the bounce batch's counted walk,
    ``bounce`` = measure_shape's reading, without the finalize step, and
    the state's 88 B a lane written). Runs beside the path kernels' build
    (it needs P1's libraries only)."""
    R = args[3].x.shape[0]
    active = args[7]
    out = {}
    for rows in ("nl8", "nl5"):
        sc = scene if rows == "nl8" else nl5_scene(scene)
        a = (sc, *args[1:])
        CT.reset_launches()
        done_at, longest, calls = completion_steps(a, kwargs)
        launches = CT.bounded_launches
        require(launches == calls == CT.launches_by_rows[rows] and launches > 0,
                f"bounded {rows}: {launches} bounded launches for {calls} calls")
        steps = done_at[active].cpu().numpy()
        checks = {}
        for k in (*BOUNDED_STEPS, longest):
            st = CT.ray_query_cuda(*a, **kwargs, max_steps=k, return_state=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sp = ray_query_plain(*a, **kwargs, max_steps=k, return_state=True)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            differ = state_bits_differ(st, sp)
            require(not differ, f"bounded {rows} at {k} steps: state fields {differ} differ")
            checks[k] = {"done_share": float(st.done[active].float().mean()),
                         "plain_ms": plain_ms, "state_bit_equal": True}
        hb, ob = CT.ray_query_cuda(*a, **kwargs, max_steps=longest)
        hu, ou = CT.ray_query_cuda(*a, **kwargs)
        require(all(torch.equal(bits(x), bits(y)) for x, y in zip((*hb, ob), (*hu, ou))),
                f"bounded {rows} at the longest lane's {longest} steps: hits differ")
        t = time_launches({
            "bounded_state": lambda: CT.ray_query_cuda(*a, **kwargs, max_steps=longest,
                                                       return_state=True),
            "query": lambda: CT.ray_query_cuda(*a, **kwargs)}, reps=3)
        out[rows] = {
            "launches": launches, "longest_steps": longest, "checks": checks,
            "completion_steps_upper": {f"p{p}": int(np.quantile(steps, p / 100))
                                       for p in (50, 90, 99, 100)},
            "hits_at_longest_equal_unbounded": True,
            "ms": t["bounded_state"][0], "ms_all": t["bounded_state"][1],
            "query_ms_same_call": t["query"][0], "plain_ms": checks[longest]["plain_ms"]}
        if rows == "nl8":
            hits = int((st.c_inst >= 0).sum())
            io_b = ray_io_bytes(kwargs.get("anyhit", False), args[6], R,
                                int(active.sum())) + R * (4 * len(_TravState._fields) - 22)
            out[rows].update(bound(
                bounce["table_bytes_needed"], io_b,
                bounce["node_sectors"] * SECTOR_B + (bounce["tri_rows"] - hits) * TRI_ROW_B
                + (bounce["inst_rows"] - hits) * INST_ROW_B,
                bounce["node_rows"] * NODE_FLOPS + (bounce["tri_rows"] - hits) * TRI_FLOPS
                + (bounce["inst_rows"] - hits) * INST_FLOPS))
    emit("bounded_walk_check", batch="golden bounce", rays=R, steps=list(BOUNDED_STEPS),
         **out)
    return out


def phase_wide_scenes(scene_g):
    """The golden scene packed wide in each shipped layout (TESTING preset)."""
    scenes = {}
    for name in ("w8", "w16", "s8"):
        t0 = time.perf_counter()
        # leaf_bundle=None: twice the layout's leaf width, so LEAF rows chain
        s = scene_device_from_golden(
            scene_g, TESTING, wide=True, leaf_bundle=None, wide_layout=name
        )
        sec = time.perf_counter() - t0
        nbytes = lambda x: x.numel() * x.element_size()
        emit("wide_scene", layout=name, seconds=sec,
             wide_rows=list(s.wide_rows.shape), wide_rows_bytes=nbytes(s.wide_rows),
             wide_root=list(s.wide_root.shape), wide_root_bytes=nbytes(s.wide_root),
             tri_shade=list(s.tri_shade.shape), tri_shade_bytes=nbytes(s.tri_shade),
             table_bytes=CW.table_bytes(s))
        scenes[name] = s
    return scenes


def phase_wide_kernel_check(scene_g, rays_g, wide_scenes, binary_out, prod_cfg,
                            prod_wide):
    """wide_ray_query kernel vs its plain version, the oracle and the binary
    kernel, per layout, also with a tail-only root table and its base; then
    the main path's batches: both on the main path's layout with times and
    bound, and the primary one on the other layouts (checked, not timed)."""
    max_err = 0.0
    for name, scene in wide_scenes.items():
        inp = rays_gold_inputs(scene_g, rays_g, scene.nl8.device)
        errs, out = run_modes(scene, inp, CW.wide_ray_query_cuda,
                              wide_ray_query_plain, per_lane_tmin=True)
        require((inp["R"] - 37) % CW.block_size() != 0, "ragged batch is a block multiple")
        oracle_ties = check_oracle(rays_g, out["closest"][0], out["anyhit"][1])
        ties = {
            m: id_mismatches(f"{name} {m} vs ray_query", *out[m], *binary_out[m])
            for m in binary_out
        }
        # what a frame packer ships: the root table's tail and its base row.
        # Same modes against the plain version; same bits as with the whole table
        off = int(scene_g["tlas"][1])
        require(off > 0, "the golden TLAS offset is 0: the base would be idle")
        tail = scene._replace(
            wide_root=scene.wide_root[off:].contiguous(),
            wide_root_base=torch.tensor([off], dtype=torch.int32,
                                        device=scene.wide_root.device),
        )
        tail_errs, tail_out = run_modes(tail, inp, CW.wide_ray_query_cuda,
                                        wide_ray_query_plain, per_lane_tmin=True)
        for m, (h_full, o_full) in out.items():
            h_tail, o_tail = tail_out[m]
            require(all(bool(torch.equal(a, b)) for a, b in
                        zip((*h_full, o_full), (*h_tail, o_tail))),
                    f"{name} {m}: a root table with a base gives other bits")
        errs = {**errs, **{m + "+root_base": e for m, e in tail_errs.items()}}
        edge = run_edge_modes(scene, scene_g, rays_g, CW.wide_ray_query_cuda,
                              wide_ray_query_plain, f"wide_ray_query {name}")
        errs.update({"edge " + m: e for m, e in edge.items()})
        emit("wide_kernel_check", part="rays.gold", layout=name, rays=inp["R"],
             modes=list(errs), max_abs_err=max(errs.values()), rtol=RTOL, atol=ATOL,
             oracle_id_mismatches=oracle_ties, id_mismatches_vs_ray_query=ties,
             root_base=off, ids="equal to the plain version's")
        max_err = max(max_err, *errs.values())

    lanes = main_path_tile_lanes(prod_cfg, prod_wide)
    calls = capture_main_path_queries(prod_cfg, prod_wide, lanes)
    require(len(calls) == 1 + prod_cfg.max_bounces, f"{len(calls)} ray queries per sample")
    shapes = [
        measure_wide_shape("primary", *calls[0]),
        measure_wide_shape("bounce", *calls[1]),
    ]
    require(shapes[1]["rays"] == 2 * lanes, "bounce batch is not 2 x tile")
    require(shapes[1]["active"] < shapes[1]["rays"], "bounce batch holds no inactive lane")
    for s in shapes:
        emit("wide_kernel_check", part="main_path_shape", **s)
    max_err = max(max_err, *(s["max_abs_err"] for s in shapes))

    # the other instantiations at a main-path batch: the same primary rays on
    # the same scene packed in their layout
    scene_args, kwargs = calls[0]
    other_times = {}
    for name in wide_scenes:
        if name == MAIN_LAYOUT:
            continue
        other = scene_device_from_golden(scene_g, prod_cfg, wide=True, wide_layout=name)
        other_args = (other, *scene_args[1:])
        _, c, plain_ms, err, ties = check_wide_batch(f"primary {name}", other_args, kwargs)
        # its time beside w8's on the same rays, in turns
        t = time_launches({
            MAIN_LAYOUT: lambda: CW.wide_ray_query_cuda(*scene_args, **kwargs),
            name: lambda: CW.wide_ray_query_cuda(*other_args, **kwargs),
        })
        lay = LAYOUTS_BY_WIDTH[other.wide_rows.shape[1]]
        emit("wide_kernel_check", part="main_path_shape_other_layout", shape="primary",
             layout=name, rays=lanes, max_abs_err=err, plain_ms=plain_ms,
             ms=t[name][0], ms_all=t[name][1], w8_ms_same_call=t[MAIN_LAYOUT][0],
             w8_ms_all=t[MAIN_LAYOUT][1], id_mismatches_vs_ray_query=ties,
             **scalars(c),
             **walk_stats(c.lane_steps, scene_args[7], c.row_visits, lay.w_row * 4))
        other_times[name] = t[name][0]
        max_err = max(max_err, err)
    return max_err, shapes, other_times


def phase_breakdown(cfg, scene, tag):
    """One tile, one sample: how much of its time is the kernel."""
    spans = []
    orig = integrator.ray_query

    def timed(*a, **k):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = orig(*a, **k)
        e1.record()
        spans.append((e0, e1))
        return out

    lanes = main_path_tile_lanes(cfg, scene)
    idx = torch.arange(lanes, dtype=torch.int32, device="cuda")
    xs, ys = idx % cfg.image_width, idx // cfg.image_width
    si = torch.zeros_like(xs)
    integrator.path_trace_samples(cfg, scene, xs, ys, si)  # warm-up
    torch.cuda.synchronize()
    integrator.ray_query = timed
    try:
        t0 = time.perf_counter()
        integrator.path_trace_samples(cfg, scene, xs, ys, si)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        integrator.ray_query = orig
    per_query = [a.elapsed_time(b) for a, b in spans]
    emit("breakdown", scene=tag, lanes=lanes, samples=1,
         sample_wall_ms=wall_ms, ray_query_ms=per_query,
         ray_query_ms_total=sum(per_query),
         ray_query_share=sum(per_query) / wall_ms)


def check_bucket_order(tag, table, idx) -> dict:
    """The counting pass's order: a permutation of [0, R), its rows the
    batch's, its buckets ascending and each as full as the batch makes it."""
    n_rows, width = table.shape
    got = GP.bucket_order_cuda(table, idx)
    require(got is not None, f"{tag}: no counting pass")
    rows, pos = (t.long() for t in got)
    R = idx.numel()
    require(bool(torch.equal(torch.sort(pos).values, torch.arange(R, device=pos.device))),
            f"{tag}: positions are not a permutation of [0, R)")
    require(bool(torch.equal(rows, idx.long()[pos])), f"{tag}: rows differ from idx[pos]")
    shift = GP.slice_shift(n_rows, width)
    bucket = rows >> shift
    require(bool((bucket[1:] >= bucket[:-1]).all()), f"{tag}: buckets out of order")
    n_buckets = GP.buckets(n_rows, width, R)
    require(bool(torch.equal(torch.bincount(bucket, minlength=n_buckets),
                             torch.bincount(idx.long() >> shift, minlength=n_buckets))),
            f"{tag}: bucket sizes differ")
    return {"buckets": n_buckets, "non_empty": int((torch.bincount(bucket) > 0).sum())}


def gather_shape(table, idx, k=16) -> dict:
    """One probe shape: the kernel and index_select in turns (L2 flushed,
    median and all 5), the device time of each (the kernel's by kernel:
    counting pass and copy), and the bound: rows touched read once, indices
    read once, rows written once."""
    (n_rows, width), lanes = table.shape, idx.numel()
    fns = {"kernel": lambda: GP.gather_rows_cuda(table, idx, k),
           "index_select": lambda: GP.gather_rows_plain(table, idx)}
    t = time_launches(fns)
    split = {name: kernel_split(fn) for name, fn in fns.items()}
    touched = int(torch.unique(idx).numel())
    move = touched * width * 4 + lanes * 4 + lanes * width * 4
    by_kernel = split["kernel"]["device_ms_by_kernel"]
    bound_ms = move / HBM_BYTES_PER_S * 1e3
    return {
        "table": [n_rows, width], "lanes": lanes, "k": k, "rows_touched": touched,
        "buckets": GP.buckets(n_rows, width, lanes),
        "ms": t["kernel"][0], "ms_all": t["kernel"][1],
        "device_ms": split["kernel"]["device_ms"], "host_ms": split["kernel"]["host_ms"],
        "count_pass_device_ms": sum(v for n, v in by_kernel.items()
                                    if any(f"gather_{k}" in n
                                           for k in ("count", "offsets", "scatter"))),
        "copy_device_ms": sum(v for n, v in by_kernel.items() if "gather_copy" in n),
        "device_ms_by_kernel": by_kernel,
        "index_select_ms": t["index_select"][0], "index_select_ms_all": t["index_select"][1],
        "index_select_device_ms": split["index_select"]["device_ms"],
        "bound_ms": bound_ms, "bound_by": "bytes", "bytes_moved": move,
        "share": bound_ms / t["kernel"][0],
        "device_share": bound_ms / split["kernel"]["device_ms"],
    }


def phase_gather_probe(smi):
    """The gather kernel against ``index_select`` (bit-equal) on the probe's
    four shapes at k = 1, 16, 32 and on three hostile index lists, the
    counting pass's order, each shape timed beside ``index_select`` with its
    bound and its split, a sweep of k on the large table, then the probe's
    own entry point with the count at 0."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(3)
    i32 = lambda a: torch.from_numpy(np.asarray(a, dtype=np.int32)).to(dev)
    checked, shapes, orders, hostile, sweep = [], [], {}, {}, {}

    def hold(tag, table, idx, ks=(1, 16, 32)):
        ref = GP.gather_rows_plain(table, idx)
        for k in ks:
            got = GP.gather_rows(table, idx, k)
            torch.cuda.synchronize()
            require(got.shape == ref.shape and bool(torch.equal(got, ref)),
                    f"gather_rows k={k} on {tag} differs from index_select")

    for n_rows, width in GP.TABLES:
        table = GP.make_table(rng, n_rows, width, dev)
        for lanes in GP.LANES:
            tag = f"{n_rows}x{width}, {lanes} lanes"
            idx = i32(rng.integers(0, n_rows, lanes))
            hold(tag, table, idx)
            checked.append([n_rows, width, lanes])
            if GP.buckets(n_rows, width, lanes) > 1:
                orders[tag] = check_bucket_order(tag, table, idx)
            shapes.append(gather_shape(table, idx))
        if (n_rows, width) == GP.TABLES[-1]:
            lanes = GP.LANES[-1]
            span = 1 << GP.slice_shift(n_rows, width)
            lists = {
                "one_row": np.full(lanes, n_rows // 3),
                "sorted": np.sort(rng.integers(0, n_rows, lanes)),
                "one_bucket": 5 * span + rng.integers(0, span, lanes),
            }
            for name, a in lists.items():
                idx = i32(a)
                hold(f"{name}, {tag}", table, idx, ks=(16,))
                hostile[name] = check_bucket_order(name, table, idx)
            idx = i32(rng.integers(0, n_rows, lanes))
            t = time_launches({k: (lambda k=k: GP.gather_rows_cuda(table, idx, k))
                               for k in (4, 8, 16, 32)})
            sweep = {k: {"ms": v[0], "ms_all": v[1]} for k, v in t.items()}
        del table
    emit("gather_probe", part="check", equal_to_index_select=checked,
         k=[1, 16, 32], max_abs_err=0.0, hostile_lists=hostile, bucket_orders=orders,
         card=smi)
    for sh in shapes:
        emit("gather_probe", part="shape", card=smi, **sh)
    emit("gather_probe", part="k_sweep", card=smi, table=list(GP.TABLES[-1]),
         lanes=GP.LANES[-1], ms=sweep)

    GP.reset_launches()
    results = GP.main(["--iters", "3"])
    launches = GP.launches
    require(launches > 0, "the probe launched no gather kernel")
    require({r["gather"] for r in results} == {"kernel", "index_select"}
            and all(np.isfinite(r["ms"]) and r["ms"] > 0 for r in results),
            "probe results")
    emit("gather_probe", part="harnesses", launches=launches, card=smi,
         results=[{k: r[k] for k in ("table", "lanes", "reps", "k", "harness",
                                     "gather", "ms", "ns_per_row",
                                     "payload_gb_per_s")} for r in results])
    return launches, shapes, sweep


def frame_pixels(cfg):
    idx = np.arange(cfg.image_width * cfg.image_height, dtype=np.int32)
    return idx % cfg.image_width, idx // cfg.image_width


def phase_oracle_frame(scene, phase="oracle_frame", megakernel=False, wavefront=False):
    """The 640x360 frame against the oracle's: the scan (pinned, whatever
    the scene's tables), the megakernel, or the wavefront."""
    rg = load_golden(str(GOLDEN / "render8.gold"))
    ref = rg["colors"]
    CM.reset_launches()
    CWF.reset_launches()
    t0 = time.perf_counter()
    colors = render_pixels(TESTING, scene, *frame_pixels(TESTING), spp=8,
                           megakernel=megakernel, wavefront=wavefront).reshape(ref.shape)
    sec = time.perf_counter() - t0
    require((CM.launches > 0) == megakernel, f"{phase}: {CM.launches} megakernel launches")
    require((CWF.launches > 0) == wavefront, f"{phase}: {CWF.launches} wavefront launches")
    require(colors.shape == ref.shape and np.isfinite(colors).all(), "oracle frame shape/finite")
    rel = np.abs(colors - ref) / (np.abs(ref) + 1e-3)
    q98 = float(np.quantile(rel, 0.98))

    def tm(c):
        t = torch.from_numpy(np.ascontiguousarray(c.reshape(-1, 3))).cuda()
        b, g, r, _ = tonemap(Vec3(t[:, 0], t[:, 1], t[:, 2]))
        return torch.stack([b, g, r], -1).cpu().numpy().astype(np.float64)

    mse = ((tm(colors) - tm(ref)) ** 2).mean()
    psnr = float(10 * np.log10(255.0**2 / max(mse, 1e-12)))
    emit(phase, width=640, height=360, spp=8, bounces=TESTING.max_bounces,
         renderer="megakernel" if megakernel else ("wavefront" if wavefront else "scan"),
         rel_q98=q98, rel_q98_bar=1e-3, psnr_db=psnr, psnr_bar_db=35.0, seconds=sec)
    require(q98 < 1e-3, f"{phase} rel q98 {q98}")
    require(psnr > 35.0, f"{phase} PSNR {psnr}")
    return float(np.minimum(ref, 10.0).mean())


def phase_main_path(cfg, scene, oracle_mean, wide: bool, binary_colors=None):
    """The full-width frame. Both kernels' counts are set to 0 just before
    and read just after: the frame must go through its own kernel for every
    ray query and through the other for none."""
    phase = "main_path_wide" if wide else "main_path"
    W, H = cfg.image_width, cfg.image_height
    tiles = -(-W * H // tile_pixels(scene))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    CT.reset_launches()
    CW.reset_launches()
    CM.reset_launches()
    CWF.reset_launches()
    t0 = time.perf_counter()
    # the scan, pinned: on the card render_frame takes a wide scene through
    # the megakernel (main_path_megakernel)
    colors = render_pixels(cfg, scene, *frame_pixels(cfg), spp=MAIN_SPP,
                           megakernel=False).reshape(H, W, 3)
    image = to_bgra(colors)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    binary_launches, wide_launches = CT.launches, CW.launches
    peak = torch.cuda.max_memory_allocated()
    require(CM.launches == 0 and CWF.launches == 0,
            f"{phase}: {CM.launches} megakernel, {CWF.launches} wavefront launches in the scan")

    expected = tiles * MAIN_SPP * (1 + cfg.max_bounces)
    launches, other = (wide_launches, binary_launches) if wide else (
        binary_launches, wide_launches)
    require(colors.shape == (H, W, 3) and image.shape == (H, W, 4), "frame shape")
    require(image.dtype == np.uint8, "image dtype")
    require(np.isfinite(colors).all(), "non-finite radiance")
    require(launches == expected, f"{launches} kernel launches, expected {expected}")
    require(other == 0, f"{other} launches of the other walk's kernel")
    # same scene and camera as the oracle's 640x360 frame: the mean radiance
    # (fireflies clipped) must agree, whatever the resolution
    mean_ratio = float(np.minimum(colors, 10.0).mean()) / oracle_mean
    require(0.9 < mean_ratio < 1.1, f"mean radiance vs oracle frame: {mean_ratio}")
    extra = {}
    if binary_colors is not None:
        # the wide walk confirms the same candidates as the binary one; only
        # an exactly-equal-t tie inside a LEAF bundle may resolve differently
        equal = (colors == binary_colors).all(axis=-1)
        rel = np.abs(colors - binary_colors) / (np.abs(binary_colors) + 1e-3)
        q98 = float(np.quantile(rel, 0.98))
        extra = {"pixels_bit_equal_to_binary_frame": float(equal.mean()),
                 "rel_q98_vs_binary_frame": q98}
        require(q98 < 1e-3, f"wide frame vs binary frame: rel q98 {q98}")

    out = ROOT / "output"
    out.mkdir(exist_ok=True)
    bmp = out / ("chip_smoke_frame_wide.bmp" if wide else "chip_smoke_frame.bmp")
    write_bmp(str(bmp), image)
    back = read_bmp(str(bmp))
    require(np.array_equal(back[..., ::-1], image[..., :3]), "BMP round trip")
    emit(phase, width=W, height=H, bounces=cfg.max_bounces, spp=MAIN_SPP,
         spp_reduced_from=PRODUCTION.samples_per_pixel, tiles=tiles,
         tile_pixels=tile_pixels(scene), launches=launches,
         launches_expected=expected, launches_of_other_kernel=other, seconds=sec,
         msamples_per_s=W * H * MAIN_SPP / sec / 1e6,
         peak_memory_allocated_bytes=int(peak), mean_vs_oracle=mean_ratio,
         bmp=str(bmp.relative_to(ROOT)), bmp_bytes=bmp.stat().st_size, **extra)
    return launches, colors, sec


# ---------------------------------------------------------------- megakernel

MK_BAR = 2e-4  # tests/test_megakernel.py's bar for the JAX megakernel vs its scan


def mk_compare(tag, got, ref, spp, sample_base, pixel_base, W, bar=MK_BAR, xy=None):
    """The kernel's per-pixel sums against the plain version's: the share of
    the plain version's pixels that are finite (>= 99 %), the share of those
    within bar + bar |ref| on every channel (>= 97 %), the bit-equal share,
    the max abs error over finite pixels, and the worst pixels as (x, y,
    first sample, samples). ``xy``: the (xs, ys) numpy arrays of a pixel
    list (entry i is pixel (xs[i], ys[i])), else entry i is pixel
    pixel_base + i of a row-major frame W wide."""
    got = torch.stack(got, -1).double().cpu().numpy()
    ref = torch.stack(ref, -1).double().cpu().numpy()
    finite = np.isfinite(ref).all(-1)
    err = np.abs(got - ref)
    close = finite & (err <= bar + bar * np.abs(ref)).all(-1)
    equal = (got == ref).all(-1) | (np.isnan(got) & np.isnan(ref)).all(-1)
    worst_err = np.where(finite, (err / (bar + bar * np.abs(ref))).max(-1), -1.0)
    worst = np.argsort(worst_err)[::-1][:3]
    out = {
        "case": tag, "pixels": len(ref), "spp": spp, "sample_base": sample_base,
        "pixel_base": pixel_base, "finite_share": float(finite.mean()),
        "close_share": float(close.sum() / max(finite.sum(), 1)), "bar": bar,
        "bit_equal_share": float(equal.mean()),
        "max_abs_err": float(err[finite].max()) if finite.any() else 0.0,
        "worst": [{"x": int(xy[0][i] if xy else (pixel_base + i) % W),
                   "y": int(xy[1][i] if xy else (pixel_base + i) // W),
                   "sample": sample_base, "samples": spp,
                   "err_over_bar": float(worst_err[i])} for i in worst],
    }
    require(out["finite_share"] >= 0.99, f"{tag}: finite share {out['finite_share']}")
    require(out["close_share"] >= 0.97, f"{tag}: share within the bar {out['close_share']}")
    return out


def mk_case(tag, cfg, scene, n, spp, sample_base=0, pixel_base=0, order=None,
            with_stats=False):
    """One call of the public entry point on the card against the plain
    version on the same inputs. Returns the comparisons and the kernel's
    output."""
    order_t = None if order is None else torch.from_numpy(order).cuda()
    out = path_trace_megakernel(cfg, scene, n, spp, sample_base, pixel_base,
                                with_stats=with_stats, return_truncated=True,
                                pixel_order=order, device="cuda")
    acc, l2, n_trunc = (out[0], out[1], out[2]) if with_stats else (out[0], None, out[1])
    ref = path_trace_megakernel_plain(cfg, scene, n, spp, sample_base, pixel_base,
                                      with_stats, order_t)
    torch.cuda.synchronize()
    require(int(n_trunc[0]) == 0, f"{tag}: {int(n_trunc[0])} samples abandoned")
    res = [mk_compare(tag, tuple(acc), ref[:3], spp, sample_base, pixel_base,
                      cfg.image_width)]
    if with_stats:
        # the plane is a square: twice the relative error
        res.append(mk_compare(tag + " lum2", (l2,), (ref[3],), spp, sample_base,
                              pixel_base, cfg.image_width, bar=2 * MK_BAR))
    return res, acc


def phase_megakernel_check(scene_wide, scene_motion):
    """The kernel against its plain version on the golden 640x360 frame
    (TESTING, wide w8 tables with chained leaves) and on motion.gold's scene,
    whose four subframe rows differ (the golden scene's are all equal, so a
    wrong row would not show there)."""
    cfg = TESTING
    W, H = cfg.image_width, cfg.image_height
    N = W * H
    ragged = N - 1000 - 37
    require(ragged % CM.block_size() != 0, "ragged slot count is a block multiple")
    rows = scene_motion.sf_tlas_offset.shape[0]
    require(len({tuple(r) for r in scene_motion.sf_light.cpu().numpy().tolist()}) > 1
            and len(set(scene_motion.sf_tlas_offset.tolist())) > 1,
            "motion.gold's subframe rows are all equal")
    past = cfg.samples_per_motion_blur_step * rows + 5
    results = []
    res, first = mk_case("spp1", cfg, scene_wide, N, 1)
    results += res
    for tag, kw in (
        ("spp4_base5", dict(spp=4, sample_base=5)),
        ("pixel_base_ragged", dict(spp=2, pixel_base=1000, n=ragged)),
        ("morton_order", dict(spp=1, order=morton_pixel_order(W, H))),
        ("with_stats", dict(spp=2, sample_base=3, with_stats=True)),
    ):
        n = kw.pop("n", N)
        results += mk_case(tag, cfg, scene_wide, n, **kw)[0]
    for tag, base in (("motion_negative_base", -3), ("motion_past_the_rows", past)):
        results += mk_case(tag, cfg, scene_motion, N, 2, sample_base=base)[0]
    # two launches of one call give the same bytes
    again = path_trace_megakernel(cfg, scene_wide, N, 1, device="cuda")
    torch.cuda.synchronize()
    require(all(torch.equal(a, b) for a, b in zip(first, again)),
            "two launches of the same call differ")
    # the step cap: at 8 rows a ray most samples are abandoned and counted;
    # an abandoned sample is not folded (its pixel keeps 0 at spp 1), and a
    # pixel whose sample was not abandoned keeps its bits
    cr, cg, cb, _, n_trunc, _ = CM.megakernel_cuda(cfg, scene_wide, N, 1, max_steps=8)
    torch.cuda.synchronize()
    capped = int(n_trunc[0])
    moved = (cr != first.x) | (cg != first.y) | (cb != first.z)
    require(0 < capped <= N, f"{capped} samples abandoned at a cap of 8 rows")
    require(int(moved.sum()) <= capped
            and bool(((cr[moved] == 0) & (cg[moved] == 0) & (cb[moved] == 0)).all()),
            "the step cap changed a pixel it did not abandon")
    for r in results:
        emit("megakernel_check", **r)
    emit("megakernel_check", part="summary", cases=len(results),
         min_close_share=min(r["close_share"] for r in results),
         min_bit_equal_share=min(r["bit_equal_share"] for r in results),
         two_launches_byte_equal=True, samples_abandoned=0,
         abandoned_at_cap_8=capped, pixels_changed_at_cap_8=int(moved.sum()),
         motion_subframe_rows=rows, motion_past_base=past)
    return max(r["max_abs_err"] for r in results)


def wf_case(tag, cfg, scene, xs, ys, spp, sample_base=0, with_stats=False):
    """One call of the public entry point on the card against the plain
    version on the same inputs (``xs``, ``ys``: int32 CUDA tensors). Returns
    the comparisons and the kernel's output."""
    out = path_trace_wavefront(cfg, scene, xs, ys, spp, sample_base, with_stats=with_stats,
                               return_truncated=True, device="cuda")
    acc, l2, n_trunc = (out[0], out[1], out[2]) if with_stats else (out[0], None, out[1])
    ref = path_trace_wavefront_plain(cfg, scene, xs, ys, spp, sample_base, with_stats)
    torch.cuda.synchronize()
    require(int(n_trunc[0]) == 0, f"{tag}: {int(n_trunc[0])} samples abandoned")
    xy = (xs.cpu().numpy(), ys.cpu().numpy())
    res = [mk_compare(tag, tuple(acc), ref[:3], spp, sample_base, 0, cfg.image_width, xy=xy)]
    if with_stats:
        # the plane is a square: twice the relative error
        res.append(mk_compare(tag + " lum2", (l2,), (ref[3],), spp, sample_base, 0,
                              cfg.image_width, bar=2 * MK_BAR, xy=xy))
    return res, acc


def phase_wavefront_check(scenes, motion):
    """The wavefront kernel against its plain version on the golden 640x360
    frame's camera, on the binary tables and the three wide layouts, over a
    random list of the frame's size (entries drawn with replacement, so
    pixels repeat, plus a run of one pixel); on motion.gold's scene (binary
    and w8) below and past its subframe rows; two launches byte-equal; on w8
    the row-major list bit-equal to the megakernel; a cap of 8 rows; the
    device-side average and tonemap of both fused renderers at spp 3
    byte-equal to the host's float32 division and to_bgra."""
    cfg = TESTING
    W, H = cfg.image_width, cfg.image_height
    N = W * H
    rng = np.random.default_rng(11)
    xs_np = rng.integers(0, W, N).astype(np.int32)
    ys_np = rng.integers(0, H, N).astype(np.int32)
    xs_np[100:164], ys_np[100:164] = 300, 250  # a run of one pixel (geometry)
    xs, ys = (torch.from_numpy(a).cuda() for a in (xs_np, ys_np))
    rows = motion["binary"].sf_tlas_offset.shape[0]
    past = cfg.samples_per_motion_blur_step * rows + 5
    results, summary = [], {}
    for name, scene in scenes.items():
        case = lambda tag, *a, **k: wf_case(f"{name} {tag}", cfg, scene, *a, **k)
        res, first = case("random_dups", xs, ys, 2)
        require(bool((first.x[100:164] == first.x[100]).all()), f"{name}: duplicates differ")
        results += res
        results += case("spp1", xs, ys, 1)[0]
        results += case("spp4_base5", xs, ys, 4, 5)[0]
        results += case("with_stats", xs, ys, 2, 3, with_stats=True)[0]
        for r in EDGE_R:
            results += case(f"R={r}", xs[:r].contiguous(), ys[:r].contiguous(), 1, 7)[0]
        if name in motion:
            for tag, base in (("motion_negative_base", -3), ("motion_past_the_rows", past)):
                results += wf_case(f"{name} {tag}", cfg, motion[name], xs, ys, 2, base)[0]
        # an empty list launches nothing and returns empty sums
        before = CWF.launches
        empty = path_trace_wavefront(cfg, scene, xs[:0], ys[:0], 2, device="cuda")
        require(CWF.launches == before and all(v.shape == (0,) for v in empty),
                f"{name}: the empty list")
        # two launches of one call give the same bytes
        a = path_trace_wavefront(cfg, scene, xs, ys, 1, device="cuda")
        b = path_trace_wavefront(cfg, scene, xs, ys, 1, device="cuda")
        torch.cuda.synchronize()
        require(all(torch.equal(u, v) for u, v in zip(a, b)), f"{name}: two launches differ")
        # the step cap: at 8 rows a ray samples are abandoned and counted;
        # an abandoned sample is not folded, an entry whose sample was not
        # abandoned keeps its bits
        cr, cg, cb, _, n_trunc, _ = CWF.wavefront_cuda(cfg, scene, xs, ys, 1, max_steps=8)
        torch.cuda.synchronize()
        capped = int(n_trunc[0])
        moved = (cr != a.x) | (cg != a.y) | (cb != a.z)
        require(0 < capped <= N, f"{name}: {capped} samples abandoned at a cap of 8 rows")
        require(int(moved.sum()) <= capped
                and bool(((cr[moved] == 0) & (cg[moved] == 0) & (cb[moved] == 0)).all()),
                f"{name}: the step cap changed an entry it did not abandon")
        summary[name] = {"abandoned_at_cap_8": capped, "entries_changed_at_cap_8":
                         int(moved.sum()), "step_cap": CM.step_cap(scene)}
    # on the row-major list, K5 on w8 is K2's body: the same bits
    idx = torch.arange(N, dtype=torch.int32, device="cuda")
    k5 = path_trace_wavefront(cfg, scenes["w8"], idx % W, idx // W, 2, 1, device="cuda")
    k2 = path_trace_megakernel(cfg, scenes["w8"], N, 2, 1, device="cuda")
    torch.cuda.synchronize()
    require(all(torch.equal(u, v) for u, v in zip(k5, k2)), "K5 w8 differs from K2")
    # the fused renderers' sums, average and tonemap on the device, at spp 3
    # (a division by 3 is not a multiply by its reciprocal): the host's bytes
    for renderer, scene in (("wavefront", scenes["binary"]), ("megakernel", scenes["w8"])):
        wf = renderer == "wavefront"
        colors, image = render_frame(cfg, scene, spp=3, wavefront=wf)
        raw = render_pixels(cfg, scene, *frame_pixels(cfg), spp=3, average=False,
                            wavefront=wf, megakernel=not wf)
        host = (raw / np.float32(3)).reshape(H, W, 3)
        require(colors.tobytes() == host.tobytes(), f"{renderer}: device average differs")
        require(image.tobytes() == to_bgra(host).tobytes(), f"{renderer}: device BGRA differs")
    for r in results:
        emit("wavefront_check", **r)
    emit("wavefront_check", part="summary", cases=len(results), layouts=list(scenes),
         min_close_share=min(r["close_share"] for r in results),
         min_bit_equal_share=min(r["bit_equal_share"] for r in results),
         two_launches_byte_equal=True, empty_list_launches=0, samples_abandoned=0,
         w8_bit_equal_to_megakernel=True, device_average_and_bgra_byte_equal_at_spp3=True,
         step_cap=summary, motion_subframe_rows=rows, motion_past_base=past)
    return max(r["max_abs_err"] for r in results)


def phase_main_path_fused(cfg, scene, oracle_mean, scan_colors, scan_sec, wavefront: bool):
    """The full-width frame through ``render_frame``: on the wide scene the
    megakernel (one launch per spp chunk), or with ``wavefront=True`` on the
    binary scene the wavefront (one launch per tile and spp chunk); no
    ray-query kernel and not the other fused one. The counts are set to 0
    just before and read just after."""
    phase = "main_path_wavefront" if wavefront else "main_path_megakernel"
    W, H = cfg.image_width, cfg.image_height
    N = W * H
    tile = tile_pixels(scene)
    tiles = [min(tile, N - a) for a in range(0, N, tile)]
    if wavefront:
        expected = sum(-(-MAIN_SPP // _mk_spp_chunk(t, MAIN_SPP, scene)) for t in tiles)
    else:
        expected = -(-MAIN_SPP // _mk_spp_chunk(N, MAIN_SPP, scene))
    counters = (CT, CW, CM, CWF)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mod in counters:
        mod.reset_launches()
    t0 = time.perf_counter()
    colors, image = render_frame(cfg, scene, spp=MAIN_SPP, wavefront=wavefront)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    ct, cw, cm, cwf = (mod.launches for mod in counters)
    launches, other_fused = (cwf, cm) if wavefront else (cm, cwf)
    peak = torch.cuda.max_memory_allocated()
    require(colors.shape == (H, W, 3) and image.shape == (H, W, 4), "frame shape")
    require(image.dtype == np.uint8, "image dtype")
    require(np.isfinite(colors).all(), "non-finite radiance")
    require(launches == expected, f"{phase}: {launches} launches, expected {expected}")
    require((ct, cw, other_fused) == (0, 0, 0),
            f"{phase}: ray-query kernel launches {(ct, cw)}, other fused {other_fused}")
    mean_ratio = float(np.minimum(colors, 10.0).mean()) / oracle_mean
    require(0.9 < mean_ratio < 1.1, f"mean radiance vs oracle frame: {mean_ratio}")
    # against the scan's frame on the same scene, at the JAX bar (on the
    # sums: frame * spp, exact for a power of two)
    sums = lambda c: tuple(torch.from_numpy(np.ascontiguousarray(c[..., k].reshape(-1)
                                                                 * MAIN_SPP))
                           for k in range(3))
    vs_scan = mk_compare("vs scan frame", sums(colors), sums(scan_colors), MAIN_SPP, 0, 0, W)
    colors2, image2 = render_frame(cfg, scene, spp=MAIN_SPP, wavefront=wavefront)
    require(colors2.tobytes() == colors.tobytes() and image2.tobytes() == image.tobytes(),
            f"{phase}: a second frame differs")
    # where the frame's wall time goes: render_frame's steps once more, one
    # by one, on the host's clock, each ending in a synchronise (the kernel's
    # own time is in the timing phases). render_frame makes its row-major
    # list on the device and does not check it; render_pixels checks a numpy
    # list (row_major_check)
    dev = torch.device("cuda")
    xs, ys = frame_pixels(cfg)
    steps = {}

    def step(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        steps[name] = time.perf_counter() - t0
        return out

    def device_list():
        idx = torch.arange(N, dtype=torch.int32, device=dev)
        return torch.remainder(idx, W), idx.div_(W, rounding_mode="floor")

    dxs, dys = step("pixel_list", device_list)
    raw = step("launches_and_sums", lambda: _render_fused(
        cfg, scene, dxs, dys, MAIN_SPP, 0, dev, wavefront, tile))
    avg = step("average", lambda: _average(raw, MAIN_SPP).view(H, W, 3))
    bgra = step("tonemap", lambda: _bgra(avg))
    host = step("copy_back", lambda: (avg.cpu().numpy(), bgra.cpu().numpy()))
    require(step("row_major_check", lambda: _row_major(xs, ys, W)), "the list is not row-major")
    require(host[0].tobytes() == colors.tobytes() and host[1].tobytes() == image.tobytes(),
            "the steps one by one give another frame")
    out = ROOT / "output"
    out.mkdir(exist_ok=True)
    bmp = out / f"chip_smoke_frame_{'wavefront' if wavefront else 'megakernel'}.bmp"
    write_bmp(str(bmp), image)
    back = read_bmp(str(bmp))
    require(np.array_equal(back[..., ::-1], image[..., :3]), "BMP round trip")
    emit(phase, width=W, height=H, bounces=cfg.max_bounces, spp=MAIN_SPP,
         spp_reduced_from=PRODUCTION.samples_per_pixel, tiles=len(tiles) if wavefront else 1,
         launches=launches, launches_expected=expected,
         launches_of_ray_query_kernels=[ct, cw], launches_of_other_fused_kernel=other_fused,
         seconds=sec, msamples_per_s=N * MAIN_SPP / sec / 1e6,
         scan_frame_seconds=scan_sec, speedup_vs_scan_frame=scan_sec / sec,
         peak_memory_allocated_bytes=int(peak), mean_vs_oracle=mean_ratio,
         vs_scan_frame={k: vs_scan[k] for k in ("finite_share", "close_share", "bar",
                                                "bit_equal_share", "max_abs_err")},
         second_frame_byte_equal=True, host_steps_s=steps,
         host_steps_sum_s=sum(v for k, v in steps.items() if k != "row_major_check"),
         bmp=str(bmp.relative_to(ROOT)), bmp_bytes=bmp.stat().st_size)
    return launches, sec, peak, vs_scan["bit_equal_share"]


def path_kernel_bound(scene, counts, n: int, io_bytes: int, spp: int = MAIN_SPP) -> dict:
    """The bound of a path kernel's launch from its counting build's
    counters (CM.COUNT_NAMES): the walk's visits (slab tests, triangle tests,
    BLAS entries) and the shading calls at their counted flops, against every
    table the kernel reads, read once (over millions of samples each row is
    read; the node table the binary walk reads, nl5 when the scene carries
    it, in whole 32 B sectors), and ``io_bytes`` of list and output."""
    c = dict(zip(CM.COUNT_NAMES, counts.tolist()))
    flops = (c["slab_tests"] * NODE_FLOPS + c["tri_tests"] * TRI_FLOPS
             + c["inst_rows"] * INST_FLOPS
             + sum(c[k] * f for k, f in MK_FLOPS.items()))
    nb = lambda x: 0 if x is None else x.numel() * x.element_size()
    if scene.wide_rows is not None:
        tables = (scene.wide_rows, scene.wide_root, scene.inst_f, scene.inst_u,
                  scene.tri_shade, scene.sf_cam, scene.sf_light, scene.sf_tlas_offset)
    else:
        tables = (scene.tri_pos, scene.inst_f, scene.inst_u, scene.tri_idx,
                  scene.vattr, scene.sf_cam, scene.sf_light, scene.sf_tlas_count,
                  scene.sf_tlas_offset)
    if scene.lt_tris is not None:  # the light tables, and the emission's rows
        tables += (scene.lt_tris, scene.lt_rows, scene.lt_cdf, scene.lt_seg, scene.lt_rank)
        if scene.wide_rows is not None:
            tables += (scene.tri_idx, scene.vattr)
    table_b = sum(nb(x) for x in tables)
    if scene.wide_rows is None:
        table_b += -(-nb(scene.nl8 if scene.nl5 is None else scene.nl5) // 32) * 32
    b = bound(table_b, io_bytes, 0, flops)
    return {"pixels": n, "spp": spp, "flops": flops, "table_bytes": table_b,
            "counts": c,
            "rows_per_ray": (c["node_rows"] + c["leaf_rows"] + c["inst_rows"]) / c["rays"],
            "rays_per_sample": c["rays"] / c["samples"],
            "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
            "bound_bytes_ms": b["bound_bytes_ms"], "bound_ops_ms": b["bound_ops_ms"]}


def phase_megakernel_timing(cfg, scene, smi):
    """One launch at the main path's shape (the whole frame's samples, as
    render_frame's one chunk): its time (L2 flushed, median of 3) and its
    bound from the counting build's counters of the same launch's work."""
    W, H = cfg.image_width, cfg.image_height
    n = W * H
    require(_mk_spp_chunk(n, MAIN_SPP, scene) == MAIN_SPP, "the main path is one chunk")
    t = time_launches({"k2": lambda: CM.megakernel_cuda(cfg, scene, n, MAIN_SPP)}, reps=3)
    ms, all_ms = t["k2"]
    *_, counts = CM.megakernel_cuda(cfg, scene, n, MAIN_SPP, counts=True)
    res = path_kernel_bound(scene, counts, n, 3 * 4 * n)
    require(res["counts"]["samples"] == n * MAIN_SPP, f"counted {res['counts']['samples']}")
    res.update(ms=ms, ms_all=all_ms, roofline_share=res["bound_ms"] / ms, card=smi)
    emit("megakernel_timing", **res)
    return res


def phase_wavefront_timing(cfg, binary, wide, smi):
    """One wavefront launch at the main path's shape (the whole 1080p frame's
    list, 8 spp: render_frame's one tile and one chunk) on the binary scene
    and on the w8 scene, timed in turns with the megakernel's launch on the
    w8 scene (L2 flushed, median of 3); the bound of each wavefront launch
    from its counting build's counters."""
    W, H = cfg.image_width, cfg.image_height
    n = W * H
    require(n <= tile_pixels(binary) and _mk_spp_chunk(n, MAIN_SPP, binary) == MAIN_SPP,
            "the main path is one tile and one chunk")
    xs, ys = frame_list(cfg)
    t = time_launches({
        "binary": lambda: CWF.wavefront_cuda(cfg, binary, xs, ys, MAIN_SPP),
        "w8": lambda: CWF.wavefront_cuda(cfg, wide, xs, ys, MAIN_SPP),
        "k2_w8": lambda: CM.megakernel_cuda(cfg, wide, n, MAIN_SPP),
    }, reps=3)
    out = {}
    for name, scene in (("binary", binary), ("w8", wide)):
        *_, counts = CWF.wavefront_cuda(cfg, scene, xs, ys, MAIN_SPP, counts=True)
        res = path_kernel_bound(scene, counts, n, (2 * 4 + 3 * 4) * n)
        require(res["counts"]["samples"] == n * MAIN_SPP, f"counted {res['counts']['samples']}")
        ms, all_ms = t[name]
        res.update(layout=name, ms=ms, ms_all=all_ms, roofline_share=res["bound_ms"] / ms,
                   k2_w8_ms_same_call=t["k2_w8"][0], k2_w8_ms_all=t["k2_w8"][1], card=smi)
        emit("wavefront_timing", **res)
        out[name] = res
    return out


# ----------------------------------------------------------------- tonemap


def bgra_diff(tag, got, ref) -> dict:
    """Two BGRA byte arrays of the same colours: the share of bytes equal and
    the largest difference in LSB."""
    require(got.shape == ref.shape and got.dtype == ref.dtype == np.uint8,
            f"{tag}: {got.shape} {got.dtype} vs {ref.shape} {ref.dtype}")
    d = np.abs(got.astype(np.int16) - ref.astype(np.int16))
    return {"bytes": int(d.size), "equal_share": float((d == 0).mean()),
            "max_lsb": int(d.max())}


def phase_tonemap_check(cfg, scene):
    """The BGRA bytes the card makes. trace.gold's tonemap inputs tonemapped
    on the card against the oracle's bytes, at the CPU test's bar (within 1
    LSB, tests/test_torch_integrator.py); one 1080p colour frame made on the
    card (render_frame on the wide scene) tonemapped on the card and on the
    CPU: within the same 1 LSB, and the frame's own BGRA (tonemapped on the
    card by render_frame) equal to the card's tonemap of its colours."""
    tg = load_golden(str(GOLDEN / "trace.gold"))
    vs_oracle = bgra_diff("trace.gold", to_bgra(tg["tonemap_in"][None], device="cuda")[0],
                          tg["tonemap_out"])
    colors, image = render_frame(cfg, scene, spp=MAIN_SPP)
    card = to_bgra(colors, device="cuda")
    host = to_bgra(colors, device="cpu")
    frame = bgra_diff("1080p frame", card, host)
    emit("tonemap_check", oracle=vs_oracle, frame_card_vs_cpu=frame,
         frame_pixels=int(colors.shape[0] * colors.shape[1]),
         render_frame_bgra_equals_card_tonemap=bool(np.array_equal(image, card)))
    require(vs_oracle["max_lsb"] <= 1, f"card tonemap vs oracle: {vs_oracle}")
    require(frame["max_lsb"] <= 1, f"card tonemap vs CPU tonemap: {frame}")
    require(np.array_equal(image, card), "render_frame's BGRA vs the card's tonemap")
    return {"oracle": vs_oracle, "frame": frame}


# ------------------------------------------------------------ the large scene

# ------------------------------------------------- S2: the bf16 node rows

HIT_FIELDS = ("thit", "bary_u", "bary_v", "bary_w", "inst", "prim", "back")


def nl5_scene(scene, check_cpu=True):
    """The scene with bf16 node rows packed on the card by with_bf16_nodes;
    with ``check_cpu``, byte-equal to the CPU's pack_nl5 of its nl8
    (required; the golden scene and the Cornell box are checked, the larger
    tables' walks are held to nl8's instead)."""
    s5 = with_bf16_nodes(scene)
    torch.cuda.synchronize()
    require(s5.nl5.is_cuda and tuple(s5.nl5.shape) == (scene.nl8.shape[0], 5),
            f"nl5 {tuple(s5.nl5.shape)} on {s5.nl5.device}")
    if check_cpu:
        want = pack_nl5(scene.nl8.cpu().numpy())
        require(s5.nl5.cpu().numpy().tobytes() == want.tobytes(),
                "with_bf16_nodes on the card differs from pack_nl5 on the CPU")
    return s5


def nl8_of(scene):
    """The same scene walked through its f32 rows."""
    return scene._replace(nl5=None)


def records_vs_nl8(tag, h5, o5, h8, o8, closest) -> dict:
    """A walk on nl5 rows against the same rays on nl8: ``occluded`` equal
    and every field of the closest-hit lanes bit-equal (required); the
    share of every lane's record (an any-hit lane writes no ids) and of the
    any-hit lanes' records that are bit-equal (reported)."""
    require(bool(torch.equal(o5, o8)), f"{tag}: occluded differs from nl8's")
    same = torch.ones_like(o5)
    for k in HIT_FIELDS:
        a, b = getattr(h5, k), getattr(h8, k)
        eq = (a.view(torch.int32) == b.view(torch.int32)) if a.is_floating_point() else a == b
        require(bool(eq[closest].all()), f"{tag}: {k} differs from nl8's on closest-hit lanes")
        same &= eq
    anyhit = ~closest
    return {"record_equal_share": float(same.float().mean()),
            "anyhit_lanes": int(anyhit.sum()),
            "anyhit_record_equal_share": (float(same[anyhit].float().mean())
                                          if bool(anyhit.any()) else None)}


def closest_lanes(anyhit, R, device) -> torch.Tensor:
    """The lanes of a batch that run a closest-hit query."""
    if isinstance(anyhit, torch.Tensor):
        return ~anyhit
    return torch.full((R,), not anyhit, dtype=torch.bool, device=device)


def check_nl5_batch(tag, args, kwargs, modes=(None, False, True)) -> dict:
    """One captured ray-query batch of a scene with nl5 rows, in the anyhit
    modes asked (None: as captured, False: every lane closest, True: every
    lane any-hit): P1's nl5 instance against its plain version (ids equal,
    1e-6) and against P1's nl8 instance (records_vs_nl8). Returns, per mode,
    the comparisons; for the mode as captured also the plain version's
    counts (node rows and the 32 B sectors they span)."""
    scene5 = args[0]
    a8 = (nl8_of(scene5), *args[1:])
    R = args[3].x.shape[0]
    out = {}
    for mode in modes:
        kw = dict(kwargs)
        if mode is not None:
            kw["anyhit"] = mode
        CT.reset_launches()
        h5, o5 = CT.ray_query_cuda(*args, **kw)
        h8, o8 = CT.ray_query_cuda(*a8, **kw)
        torch.cuda.synchronize()
        require(CT.launches_by_rows == {"nl8": 1, "nl5": 1},
                f"{tag}: launches {CT.launches_by_rows}")
        t0 = time.perf_counter()
        hp, op, c = ray_query_plain(*args, **kw, return_counts=True)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        name = {None: "as_captured", False: "closest", True: "anyhit"}[mode]
        res = {"max_abs_err": compare_hits(f"{tag} {name}", h5, o5, hp, op),
               "plain_ms": plain_ms,
               **records_vs_nl8(f"{tag} {name}", h5, o5, h8, o8,
                                closest_lanes(kw.get("anyhit", False), R, o5.device))}
        if mode is None:
            res["counts"] = scalars(c)
        out[name] = res
    return out


def nl5_batch_timing(tag, args, kwargs, counts5=None, counts8=None) -> dict:
    """P1's nl5 and nl8 instances in turns on one batch (L2 flushed, median
    of 5), each launch's device time, and each bound by bytes: the 32 B
    sectors of the node rows the plain walk touched (``counts*``: a batch's
    RayQueryCounts as dicts, None for no bound), the instance and triangle
    rows, the rays."""
    a8 = (nl8_of(args[0]), *args[1:])
    fns = {"nl5": lambda: CT.ray_query_cuda(*args, **kwargs),
           "nl8": lambda: CT.ray_query_cuda(*a8, **kwargs)}
    t = time_launches(fns)
    R, n_active = args[3].x.shape[0], int(args[7].sum())
    io_b = ray_io_bytes(kwargs.get("anyhit", False), args[6], R, n_active)
    out = {"rays": R, "active": n_active}
    for k, fn in fns.items():
        res = {"ms": t[k][0], "ms_all": t[k][1], **launch_device_ms(fn, "ray_query_kernel")}
        c = counts5 if k == "nl5" else counts8
        if c is not None:
            table_b = (c["node_sectors_touched"] * SECTOR_B
                       + c["inst_rows_touched"] * INST_ROW_B + c["tri_rows_touched"] * TRI_ROW_B)
            b = bound(table_b, io_b,
                      c["node_sectors"] * SECTOR_B + c["tri_rows"] * TRI_ROW_B
                      + c["inst_rows"] * INST_ROW_B,
                      c["node_rows"] * NODE_FLOPS + c["tri_rows"] * TRI_FLOPS
                      + c["inst_rows"] * INST_FLOPS)
            res.update(table_bytes_needed=table_b, node_sectors=c["node_sectors"],
                       node_rows=c["node_rows"],
                       node_sectors_touched=c["node_sectors_touched"],
                       node_rows_touched=c["node_rows_touched"], **b,
                       roofline_share=b["bound_ms"] / t[k][0])
        out[k] = res
    out["nl5_over_nl8_ms"] = out["nl5"]["ms"] / out["nl8"]["ms"]
    out["nl5_over_nl8_device_ms"] = out["nl5"]["device_ms"] / out["nl8"]["device_ms"]
    return out


def node_table_bytes(scene) -> dict:
    """Bytes of the binary tables with nl8 and with nl5 rows in its place."""
    nb = lambda x: x.numel() * x.element_size()
    rest = sum(nb(getattr(scene, k)) for k in BINARY_TABLES if k != "nl8")
    out = {"nl8": nb(scene.nl8), "binary_total_nl8": rest + nb(scene.nl8)}
    if scene.nl5 is not None:
        out.update(nl5=nb(scene.nl5), binary_total_nl5=rest + nb(scene.nl5),
                   nl5_over_nl8=nb(scene.nl5) / nb(scene.nl8))
    out.update({f"{k}_over_l2": v / L2_BYTES for k, v in list(out.items())
                if k.startswith("binary_total")})
    return out


def k5_nl5_launches(tag, cfg, scene5, xs, ys, spp, ref_sums, reps=5) -> dict:
    """One K5 launch on the nl5 rows and one on nl8 (the same scene), in
    turns (L2 flushed, median of ``reps``), each launch's device time and
    bound from its counting build; the nl5 launch's sums within the JAX bar
    of ``ref_sums`` (the plain version's, or the scan frame's) and its
    bit-equal share against the nl8 launch's."""
    n = xs.shape[0]
    scene8 = nl8_of(scene5)
    fns = {"nl5": lambda: CWF.wavefront_cuda(cfg, scene5, xs, ys, spp),
           "nl8": lambda: CWF.wavefront_cuda(cfg, scene8, xs, ys, spp)}
    t = time_launches(fns, reps=reps)
    out = {}
    sums = {}
    for k, fn in fns.items():
        r = fn()
        require(int(r[4][0]) == 0, f"{tag} {k}: {int(r[4][0])} samples abandoned")
        sums[k] = r[:3]
        cnt = CWF.wavefront_cuda(cfg, scene5 if k == "nl5" else scene8, xs, ys, spp,
                                 counts=True)[-1]
        res = path_kernel_bound(scene5 if k == "nl5" else scene8, cnt, n, (2 * 4 + 3 * 4) * n,
                                spp=spp)
        require(res["counts"]["samples"] == n * spp, f"{tag} {k}: counted {res['counts']}")
        res.update(ms=t[k][0], ms_all=t[k][1], **launch_device_ms(fn, "wavefront", reps))
        res["roofline_share"] = res["bound_ms"] / res["ms"]
        out[k] = res
    keys = ("finite_share", "close_share", "bar", "bit_equal_share", "max_abs_err")
    cmp = mk_compare(f"{tag} nl5 vs reference", sums["nl5"], ref_sums, spp, 0, 0,
                     cfg.image_width, xy=(xs.cpu().numpy(), ys.cpu().numpy()))
    vs8 = mk_compare(f"{tag} nl5 vs nl8", sums["nl5"], sums["nl8"], spp, 0, 0,
                     cfg.image_width, xy=(xs.cpu().numpy(), ys.cpu().numpy()))
    out["nl5_vs_reference"] = {k: cmp[k] for k in keys}
    out["nl5_vs_nl8"] = {k: vs8[k] for k in keys}
    out["nl5_over_nl8_ms"] = out["nl5"]["ms"] / out["nl8"]["ms"]
    out["nl5_over_nl8_device_ms"] = out["nl5"]["device_ms"] / out["nl8"]["device_ms"]
    return out


def phase_bf16_nodes_check(scene_g, rays_g, scene, prod_cfg, prod_scene, scan_colors,
                           kernel_shapes, got8, built, smi):
    """S2 on the golden scene. with_bf16_nodes on the card byte-equal to
    pack_nl5 on the CPU. P1's nl5 instance against its plain version on the
    rays of rays.gold in every mode and the launch's edge cases (run_modes,
    run_edge_modes), and against P1's nl8 instance: closest-hit fields
    bit-equal, occluded equal, the any-hit lanes' equal share printed; the
    main path's two batches (one 1080p tile: primary, and the bounce batch
    of 4,147,200 lanes as captured, all closest and all any-hit) the same
    way, and both batches timed nl5 against nl8 in turns with their bounds
    by 32 B sectors. Then the main paths on nl5 rows, counts set to 0 just
    before and read just after: the 1080p x 5 x 8 spp scan frame (P1's nl5
    instance only) against the nl8 scan frame, and the K5 frame (K5's nl5
    instance only) within the JAX bar of the nl5 scan frame (its plain
    version) and against the nl8 K5 frame; one K5 launch at that shape nl5
    against nl8 in turns with its bound; and the Cornell box's light
    instance on nl5 rows (wavefront_nl5_lit): a 1080p x 8 spp frame through
    render_frame(wavefront=True) against the nl8 frame, and one 8 spp
    launch over the frame nl5 against nl8 in turns, within the JAX bar of
    its plain version (the scan on nl5 rows, timed once)."""
    out = {}
    scene5 = nl5_scene(scene)
    inp = rays_gold_inputs(scene_g, rays_g, scene.nl8.device)
    errs, got5 = run_modes(scene5, inp, ray_query, ray_query_plain, per_lane_tmin=False)
    edge = run_edge_modes(scene5, scene_g, rays_g, ray_query, ray_query_plain, "ray_query nl5")
    modes = {"closest": False, "anyhit": True, "mixed_mask": inp["mask"],
             "inactive_lanes": inp["mask"], "ragged_tmax_lane": inp["mask"]}
    vs8 = {}
    for mode, anyhit in modes.items():
        (h5, o5), (h8, o8) = got5[mode], got8[mode]
        R = o5.shape[0]
        cl = closest_lanes(anyhit[:R] if isinstance(anyhit, torch.Tensor) else anyhit, R,
                           o5.device)
        vs8[mode] = records_vs_nl8(f"rays.gold {mode}", h5, o5, h8, o8, cl)
    emit("bf16_nodes_check", part="rays.gold", rays=inp["R"], modes=list(errs),
         max_abs_err=max(errs.values()), edge_modes=list(edge),
         edge_max_abs_err=max(edge.values()), vs_nl8=vs8, ids="equal",
         card_pack_equals_cpu=True)
    out["max_abs_err"] = max(*errs.values(), *edge.values())

    prod5 = nl5_scene(prod_scene)
    lanes = main_path_tile_lanes(prod_cfg, prod5)
    calls = capture_main_path_queries(prod_cfg, prod5, lanes)
    batches = {"primary": check_nl5_batch("nl5 primary", *calls[0], modes=(None,)),
               "bounce": check_nl5_batch("nl5 bounce", *calls[1])}
    require(calls[1][0][3].x.shape[0] == 2 * lanes, "bounce batch is not 2 x tile")
    timing = {k: nl5_batch_timing(f"nl5 {k}", *calls[i], batches[k]["as_captured"]["counts"],
                                  kernel_shapes[i])
              for i, k in enumerate(("primary", "bounce"))}
    del calls
    out["max_abs_err"] = max(out["max_abs_err"], *(m["max_abs_err"] for b in batches.values()
                                                   for m in b.values()))
    out["batches"], out["timing"] = batches, timing
    emit("bf16_nodes_check", part="main_path_batches", lanes=lanes, checks=batches,
         timing=timing, registers_spills={
             "nl5": built["ray_query_nl5"]["registers_spills"],
             "nl8": built["ray_query"]["registers_spills"]["query"]},
         blocks_per_sm={"nl5": built["ray_query_nl5"]["blocks_per_sm"],
                        "nl8": built["ray_query"]["blocks_per_sm"]},
         node_table=node_table_bytes(prod5), card=smi)

    # the main paths on nl5 rows
    W, H = prod_cfg.image_width, prod_cfg.image_height
    n = W * H
    tile = tile_pixels(prod5)
    tiles = [min(tile, n - a) for a in range(0, n, tile)]
    scan_n = len(tiles) * MAIN_SPP * (1 + prod_cfg.max_bounces)
    wf_n = sum(-(-MAIN_SPP // _mk_spp_chunk(t, MAIN_SPP, prod5)) for t in tiles)
    counters = (CT, CW, CM, CWF)
    scan5, scan_s, scan_peak, _ = frame_launches(
        "nl5 scan frame", counters, {CT: scan_n},
        lambda: render_pixels(prod_cfg, prod5, *frame_pixels(prod_cfg), spp=MAIN_SPP,
                              megakernel=False).reshape(H, W, 3))
    p1_rows = dict(CT.launches_by_rows)
    require(p1_rows == {"nl8": 0, "nl5": scan_n}, f"nl5 scan frame: P1 launches {p1_rows}")
    sums = lambda c: tuple(torch.from_numpy(np.ascontiguousarray(c[..., k].reshape(-1)
                                                                 * MAIN_SPP))
                           for k in range(3))
    keys = ("finite_share", "close_share", "bar", "bit_equal_share", "max_abs_err")
    scan_vs8 = mk_compare("nl5 scan frame vs nl8 scan frame", sums(scan5), sums(scan_colors),
                          MAIN_SPP, 0, 0, W)
    wf5, wf_s, wf_peak, _ = frame_launches(
        "nl5 K5 frame", counters, {CWF: wf_n},
        lambda: render_frame(prod_cfg, prod5, spp=MAIN_SPP, wavefront=True)[0])
    k5_tables = dict(CWF.launches_by_tables)
    require(k5_tables == {"nl8": 0, "nl5": wf_n, "wide": 0},
            f"nl5 K5 frame: launches {k5_tables}")
    wf8 = render_frame(prod_cfg, prod_scene, spp=MAIN_SPP, wavefront=True)[0]
    wf_vs_plain = mk_compare("nl5 K5 frame vs nl5 scan frame", sums(wf5), sums(scan5),
                             MAIN_SPP, 0, 0, W)
    wf_vs8 = mk_compare("nl5 K5 frame vs nl8 K5 frame", sums(wf5), sums(wf8), MAIN_SPP, 0, 0,
                        W)
    frames = {"scan": {"launches": p1_rows, "seconds": scan_s,
                       "msamples_per_s": n * MAIN_SPP / scan_s / 1e6,
                       "peak_memory_allocated_bytes": int(scan_peak),
                       "vs_nl8_scan_frame": {k: scan_vs8[k] for k in keys}},
              "wavefront": {"launches": k5_tables, "seconds": wf_s,
                            "msamples_per_s": n * MAIN_SPP / wf_s / 1e6,
                            "peak_memory_allocated_bytes": int(wf_peak),
                            "vs_nl5_scan_frame": {k: wf_vs_plain[k] for k in keys},
                            "vs_nl8_k5_frame": {k: wf_vs8[k] for k in keys}}}
    del wf5, wf8
    xs, ys = frame_list(prod_cfg)
    k5 = k5_nl5_launches("golden K5 1080p", prod_cfg, prod5, xs, ys, MAIN_SPP, sums(scan5))
    del scan5
    out.update(frames=frames, k5=k5, scan_launches=scan_n, wf_launches=wf_n,
               scan_seconds=scan_s,
               max_abs_err_k5=max(wf_vs_plain["max_abs_err"],
                                  k5["nl5_vs_reference"]["max_abs_err"]))
    emit("bf16_nodes_check", part="main_paths", width=W, height=H, spp=MAIN_SPP,
         bounces=prod_cfg.max_bounces, frames=frames, k5_launch=k5,
         registers_spills=built["wavefront_nl5"]["registers_spills_by_layout"],
         blocks_per_sm=built["nl5_blocks_per_sm"], card=smi)

    # the light instance on nl5 rows: the Cornell box
    cfg, s = cornell_scene(MAIN_SPP)
    binary = binary_tables(s)
    b5 = nl5_scene(binary)
    c5, c5_s, _, _ = frame_launches(
        "Cornell nl5 K5 frame", counters, {CWF: 1},
        lambda: render_frame(cfg, b5, spp=MAIN_SPP, wavefront=True)[0])
    lit_tables = dict(CWF.launches_by_tables)
    require(lit_tables == {"nl8": 0, "nl5": 1, "wide": 0}, f"Cornell nl5: {lit_tables}")
    c8 = render_frame(cfg, binary, spp=MAIN_SPP, wavefront=True)[0]
    lit_vs8 = mk_compare("Cornell nl5 K5 frame vs nl8", sums(c5), sums(c8), MAIN_SPP, 0, 0,
                         cfg.image_width)
    del c5, c8
    # the plain version on the launch's work: the scan on nl5 rows
    lx, ly = frame_list(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = path_trace_wavefront_plain(cfg, b5, lx, ly, MAIN_SPP)
    torch.cuda.synchronize()
    lit_plain_ms = (time.perf_counter() - t0) * 1e3
    lit = k5_nl5_launches("Cornell K5 1080p", cfg, b5, lx, ly, MAIN_SPP, ref[:3], reps=3)
    del ref
    out["lit"] = {"launches": lit_tables, "frame_seconds": c5_s,
                  "frame_vs_nl8": {k: lit_vs8[k] for k in keys}, "plain_ms": lit_plain_ms,
                  "launch": lit}
    out["max_abs_err_lit"] = lit["nl5_vs_reference"]["max_abs_err"]
    emit("bf16_nodes_check", part="cornell_lights", **out["lit"], node_table=node_table_bytes(b5),
         card=smi)
    del s, binary, b5
    return out


def phase_bf16_nodes_large(cfg, binary, qb, p1, scan_sums, smi):
    """S2 on the large scene (its binary tables ``binary``; ``qb`` the
    65,536-ray primary and first-bounce batches captured on them;
    ``p1`` P1's nl8 readings of those batches (measure_shape), ``scan_sums``
    its nl8 scan frame's sums): the binary tables' bytes with nl8
    and with nl5; P1's nl5 instance against its plain version and its nl8
    instance on the 65,536-ray batches, and nl5 against nl8 in turns on
    them and on a render tile's two batches (time, device time, bound by the
    32 B sectors the visited rows span); the scan frame on nl5 rows (P1's
    nl5 instance only) against the nl8 scan frame; one 8 spp K5 launch
    over the frame nl5 against nl8 in turns, within the JAX bar of the nl8
    scan frame."""
    W, H = cfg.image_width, cfg.image_height
    n = W * H
    b5 = nl5_scene(binary, check_cpu=False)
    tables = node_table_bytes(b5)
    emit("bf16_nodes_large", part="tables", **tables, card=smi)
    q5 = [((b5, *a[1:]), k) for a, k in qb]
    checks = {name: check_nl5_batch(f"large nl5 {name}", *q5[i], modes=(None,))
              for i, name in enumerate(("primary", "bounce"))}
    timing = {name: nl5_batch_timing(f"large {name}", *q5[i],
                                     checks[name]["as_captured"]["counts"], p1[i])
              for i, name in enumerate(("primary", "bounce"))}
    tile = main_path_tile_lanes(cfg, b5)
    tb = capture_main_path_queries(cfg, b5, tile)
    tile_t = {name: nl5_batch_timing(f"large tile {name}", *tb[i])
              for i, name in enumerate(("primary", "bounce"))}
    del tb
    emit("bf16_nodes_large", part="ray_queries", batch=LARGE_BATCH, checks=checks,
         timing=timing, tile_lanes={"primary": tile, "bounce": 2 * tile}, tile_timing=tile_t,
         card=smi)
    tiles = [min(tile_pixels(b5), n - a) for a in range(0, n, tile_pixels(b5))]
    scan_n = len(tiles) * MAIN_SPP * (1 + cfg.max_bounces)
    scan5, scan_s, scan_peak, _ = frame_launches(
        "large nl5 scan frame", (CT, CW, CM, CWF), {CT: scan_n},
        lambda: render_pixels(cfg, b5, *frame_pixels(cfg), spp=MAIN_SPP,
                              megakernel=False).reshape(H, W, 3))
    p1_rows = dict(CT.launches_by_rows)
    require(p1_rows == {"nl8": 0, "nl5": scan_n}, f"large nl5 scan: P1 launches {p1_rows}")
    sums = lambda c: tuple(torch.from_numpy(np.ascontiguousarray(c[..., k].reshape(-1)
                                                                 * MAIN_SPP))
                           for k in range(3))
    keys = ("finite_share", "close_share", "bar", "bit_equal_share", "max_abs_err")
    scan_vs8 = mk_compare("large nl5 scan vs nl8 scan", sums(scan5), scan_sums,
                          MAIN_SPP, 0, 0, W)
    k5 = k5_nl5_launches("large K5 1080p", cfg, b5, *frame_list(cfg), MAIN_SPP, sums(scan5),
                         reps=3)
    del scan5
    res = {"tables": tables, "checks": checks, "timing": timing, "tile_timing": tile_t,
           "scan": {"launches": p1_rows, "seconds": scan_s,
                    "peak_memory_allocated_bytes": int(scan_peak),
                    "vs_nl8_scan_frame": {k: scan_vs8[k] for k in keys}},
           "k5": k5}
    emit("bf16_nodes_large", part="frames", scan=res["scan"], k5_launch=k5, card=smi)
    del b5
    return res


def phase_tuning_check(smi):
    """The tuning table on the card: the rows get_tuning("cuda", ...)
    returns; then a 640x360 x 2 spp scan frame under a tuned file
    (PT_TUNED_FILE in a temporary directory) whose cuda row sets the tile to
    half the frame: twice the P1 launches of the frame without it, and the
    colours bit-equal."""
    import os
    import tempfile

    rows = {size: tuning.get_tuning("cuda", size) for size in ("small", "large")}
    cfg = TESTING
    scene = scene_device_from_golden(load_golden(str(GOLDEN / "scene.gold")), cfg)
    W, H = cfg.image_width, cfg.image_height
    spp = 2
    frame = lambda: render_pixels(cfg, scene, *frame_pixels(cfg), spp=spp, megakernel=False)
    counters = (CT, CW, CM, CWF)
    before = os.environ.get("PT_TUNED_FILE")
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["PT_TUNED_FILE"] = str(pathlib.Path(tmp) / "tuned.json")
        try:
            require(tuning.get_tuning("cuda", "small") == tuning.BUILTIN["cuda"]["small"],
                    "an empty tuned file changed the cuda row")
            tile0 = tile_pixels(scene)
            whole, whole_s, _, got0 = frame_launches("tuning: builtin tile", counters,
                                                     {CT: -(-W * H // tile0) * spp * (
                                                         1 + cfg.max_bounces)}, frame)
            tuning.record_tuning("cuda", "small", tile_pixels=W * H // 2)
            tile1 = tile_pixels(scene)
            require(tile1 == W * H // 2, f"tuned tile {tile1}")
            halves, halves_s, _, got1 = frame_launches("tuning: tuned tile", counters,
                                                       {CT: 2 * got0["cuda_traversal"]},
                                                       frame)
        finally:
            if before is None:
                os.environ.pop("PT_TUNED_FILE", None)
            else:
                os.environ["PT_TUNED_FILE"] = before
    require(halves.tobytes() == whole.tobytes(), "tuned tile: colours differ")
    require(tile_pixels(scene) == tile0, "the tuned file outlived its run")
    res = {"rows": rows, "frame": f"{W}x{H} x {spp} spp scan",
           "builtin_tile": tile0, "tuned_tile": tile1,
           "launches": {"builtin": got0["cuda_traversal"], "tuned": got1["cuda_traversal"]},
           "seconds": {"builtin": whole_s, "tuned": halves_s}, "colours_bit_equal": True}
    emit("tuning_check", **res, card=smi)
    return res


LARGE_DIR = ROOT / "build" / "large_scene"  # the generated OBJ files (git-ignored)
LARGE_BATCH = 65_536  # rays of a frame's P1 / K1 batch held to the plain versions
L2_BYTES = 50 * 1024 * 1024  # the H100's L2
BINARY_TABLES = ("nl8", "tri_pos", "tri_idx", "inst_f", "inst_u", "vattr")
WIDE_TABLES = ("wide_rows", "wide_root", "tri_shade", "inst_f", "inst_u")


def field_bytes(scene, names) -> dict:
    """Bytes of each named table of a scene."""
    return {k: getattr(scene, k).numel() * getattr(scene, k).element_size() for k in names}


def frame_launches(tag, counters, expected, fn):
    """``fn()`` with every kernel's count set to 0 just before and read just
    after: ``expected`` {module: launches} and none of the others. Returns
    fn's result, seconds (host clock to a synchronise) and peak memory."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mod in counters:
        mod.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    got = {mod.__name__.rsplit(".", 1)[-1]: mod.launches for mod in counters}
    want = {mod.__name__.rsplit(".", 1)[-1]: expected.get(mod, 0) for mod in counters}
    require(got == want, f"{tag}: launches {got}, expected {want}")
    return out, sec, torch.cuda.max_memory_allocated(), got


def phase_large_scene(cfg, smi):
    """The procedural large scene (scene/large_scene.build: its files, then
    SceneBuilder.add_mesh and SceneBuilder.build on the card, wide tables by
    default): the generated terrain at 512 x 512 vertices, 1,024 pine and
    bunny instances, a camera looking down onto it, the sun of sphere_ground;
    built by the native loader and builders (their counts required), its
    tables 5-6x the L2.
    On it: P1 and K1 on 65,536 of the frame's rays (primary and first bounce
    batch) against their plain versions, timed, with their bound by bytes
    from the rows the plain walks touched; both at a render tile's batch
    size, timed; the frame at the main path's shape by the scan on the
    binary and the w8 tables (P1, K1), by K2 (w8) and by K5 (binary and w8),
    each with its launches, seconds and peak memory, K2 and K5 against the
    scan frame on the same tables; one launch of K2 and of K5 at 8 spp timed
    (median of 5, L2 flushed) with its device time and bound; one K6 record
    launch at 1080p x 1 spp against the scan's records (every plane equal),
    timed with its device time and bound, whose primary hits give the share
    of primary rays that hit (>= 50 %) and the share that hit a placed
    object (> 0)."""
    W, H = cfg.image_width, cfg.image_height
    n = W * H
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    native_build.reset_builds()
    s, scene, host_s = large_scene.build(LARGE_DIR, cfg)
    builds = dict(native_build.builds)
    require(builds == {"obj_native": 3, "bvh_native": 4, "wide_native": 2},
            f"large scene: host builders {builds}")
    require(scene.nl8.is_cuda and scene.wide_rows is not None and scene.tri_shade is not None,
            "large scene: SceneBuilder.build's default is the wide tables on the card")
    build_peak = torch.cuda.max_memory_allocated()
    binary = binary_tables(scene)
    bin_b, wide_b = field_bytes(scene, BINARY_TABLES), field_bytes(scene, WIDE_TABLES)
    require(sum(bin_b.values()) > L2_BYTES and sum(wide_b.values()) > L2_BYTES,
            f"large scene tables {sum(bin_b.values())} / {sum(wide_b.values())} B")
    info = {"triangles": int(scene.tri_pos.shape[0]), "instances": len(s.instances),
            "vertices": int(scene.vattr.shape[0]), "nl8_rows": int(scene.nl8.shape[0]),
            "wide_rows": list(scene.wide_rows.shape),
            "binary_table_bytes": bin_b, "binary_total_bytes": sum(bin_b.values()),
            "binary_over_l2": sum(bin_b.values()) / L2_BYTES,
            "wide_table_bytes": wide_b, "wide_total_bytes": sum(wide_b.values()),
            "wide_over_l2": sum(wide_b.values()) / L2_BYTES,
            "host_seconds": host_s, "host_builders": builds,
            "peak_memory_after_build_bytes": int(build_peak)}
    emit("large_scene", **info, card=smi)

    # P1 and K1 on 65,536 of the frame's rays, spread over the frame
    idx = torch.arange(LARGE_BATCH, dtype=torch.int64, device="cuda") * n // LARGE_BATCH
    xs, ys = (idx % W).to(torch.int32), (idx // W).to(torch.int32)
    qb, qw = capture_queries(cfg, binary, xs, ys), capture_queries(cfg, scene, xs, ys)
    p1 = [measure_shape(f"large {k}", *qb[i]) for i, k in enumerate(("primary", "bounce"))]
    k1 = [measure_wide_shape(f"large {k}", *qw[i]) for i, k in enumerate(("primary", "bounce"))]
    for sh, (a, k), name in zip(p1 + k1, (*qb[:2], *qw[:2]),
                                2 * ["ray_query_kernel"] + 2 * ["wide_ray_query_kernel"]):
        sh.update(launch_device_ms(lambda: ray_query(*a, **k), name))
    # the same kernels at a render tile's batch size (the golden scene's
    # timed batches)
    tile = main_path_tile_lanes(cfg, binary)
    tb = capture_main_path_queries(cfg, binary, tile)
    tw = capture_main_path_queries(cfg, scene, tile)
    tile_t = time_launches({
        "p1_primary": lambda: ray_query(*tb[0][0], **tb[0][1]),
        "p1_bounce": lambda: ray_query(*tb[1][0], **tb[1][1]),
        "k1_primary": lambda: ray_query(*tw[0][0], **tw[0][1]),
        "k1_bounce": lambda: ray_query(*tw[1][0], **tw[1][1]),
    })
    tile_ms = {k: v[0] for k, v in tile_t.items()}
    del tb, tw
    emit("large_scene_ray_queries", batch=LARGE_BATCH, p1=p1, k1=k1,
         tile_lanes={"primary": tile, "bounce": 2 * tile}, tile_ms=tile_ms,
         tile_ms_all={k: v[1] for k, v in tile_t.items()}, card=smi)

    # the frames
    counters = (CT, CW, CM, CWF)
    tiles = [min(tile_pixels(binary), n - a) for a in range(0, n, tile_pixels(binary))]
    scan_n = len(tiles) * MAIN_SPP * (1 + cfg.max_bounces)
    chunk = _mk_spp_chunk(n, MAIN_SPP, scene)
    fused_n = -(-MAIN_SPP // chunk)
    wf_n = sum(-(-MAIN_SPP // _mk_spp_chunk(t, MAIN_SPP, scene)) for t in tiles)
    scan = lambda sc: render_pixels(cfg, sc, *frame_pixels(cfg), spp=MAIN_SPP,
                                    megakernel=False).reshape(H, W, 3)
    cases = (
        ("scan_binary", "ray_query", {CT: scan_n}, lambda: scan(binary)),
        ("scan_w8", "wide_ray_query", {CW: scan_n}, lambda: scan(scene)),
        ("megakernel_w8", "megakernel", {CM: fused_n},
         lambda: render_frame(cfg, scene, spp=MAIN_SPP)[0]),
        ("wavefront_binary", "wavefront", {CWF: wf_n},
         lambda: render_frame(cfg, binary, spp=MAIN_SPP, wavefront=True)[0]),
        ("wavefront_w8", "wavefront", {CWF: wf_n},
         lambda: render_frame(cfg, scene, spp=MAIN_SPP, wavefront=True)[0]),
    )
    frames, colors = {}, {}
    sums = lambda c: tuple(torch.from_numpy(np.ascontiguousarray(c[..., k].reshape(-1)
                                                                 * MAIN_SPP))
                           for k in range(3))
    for name, kernel, expected, fn in cases:
        c, sec, peak, got = frame_launches(f"large {name}", counters, expected, fn)
        require(c.shape == (H, W, 3) and np.isfinite(c).all(), f"large {name}: frame")
        colors[name] = c
        frames[name] = {"kernel": kernel, "seconds": sec,
                        "msamples_per_s": n * MAIN_SPP / sec / 1e6,
                        "peak_memory_allocated_bytes": int(peak),
                        "launches": sum(got.values())}
    ref_of = {"megakernel_w8": "scan_w8", "wavefront_binary": "scan_binary",
              "wavefront_w8": "scan_w8"}
    for name, ref in ref_of.items():
        cmp = mk_compare(f"large {name} vs {ref}", sums(colors[name]), sums(colors[ref]),
                         MAIN_SPP, 0, 0, W)
        frames[name]["vs_scan_frame"] = {k: cmp[k] for k in (
            "finite_share", "close_share", "bar", "bit_equal_share", "max_abs_err")}
    rel = (np.abs(colors["scan_w8"] - colors["scan_binary"])
           / (np.abs(colors["scan_binary"]) + 1e-3))
    q98 = float(np.quantile(rel, 0.98))
    frames["scan_w8"]["rel_q98_vs_scan_binary"] = q98
    frames["scan_w8"]["pixels_bit_equal_to_scan_binary"] = float(
        (colors["scan_w8"] == colors["scan_binary"]).all(-1).mean())
    require(q98 < 1e-3, f"large scan w8 vs binary: rel q98 {q98}")
    out = ROOT / "output"
    out.mkdir(exist_ok=True)
    write_bmp(str(out / "chip_smoke_large_scene.bmp"), to_bgra(colors["megakernel_w8"]))
    scan_sums = {"binary": sums(colors["scan_binary"]), "w8": sums(colors["scan_w8"])}
    del colors
    emit("large_scene_frames", width=W, height=H, bounces=cfg.max_bounces, spp=MAIN_SPP,
         fused_spp_chunk=chunk, frames=frames, card=smi)

    # one launch of each path kernel at 8 spp over the whole frame (the
    # golden scene's timed shape), its device time and bound; its sums
    # against the scan frame's (the fused frames above add the sums of
    # fused_spp_chunk samples, and so round apart from the scan's one
    # sample-ordered sum; one launch folds the 8 samples in the scan's order)
    fl = frame_list(cfg)
    launch = {"k2_w8": lambda: CM.megakernel_cuda(cfg, scene, n, MAIN_SPP),
              "k5_binary": lambda: CWF.wavefront_cuda(cfg, binary, *fl, MAIN_SPP),
              "k5_w8": lambda: CWF.wavefront_cuda(cfg, scene, *fl, MAIN_SPP)}
    # the path kernels' spread within a call is +-1 %: 3 repetitions
    t = time_launches(launch, reps=3)
    timing = {}
    for name, fn in launch.items():
        sc = binary if name == "k5_binary" else scene
        if name == "k2_w8":
            *_, counts = CM.megakernel_cuda(cfg, sc, n, MAIN_SPP, counts=True)
            io = 3 * 4 * n
        else:
            *_, counts = CWF.wavefront_cuda(cfg, sc, *fl, MAIN_SPP, counts=True)
            io = (2 * 4 + 3 * 4) * n
        res = path_kernel_bound(sc, counts, n, io)
        require(res["counts"]["samples"] == n * MAIN_SPP, f"{name}: counted {res['counts']}")
        cmp = mk_compare(f"large {name} launch vs scan frame", fn()[:3],
                         scan_sums["binary" if name == "k5_binary" else "w8"],
                         MAIN_SPP, 0, 0, W)
        res.update(ms=t[name][0], ms_all=t[name][1],
                   **launch_device_ms(fn, "megakernel" if name == "k2_w8" else "wavefront",
                                      reps=3),
                   vs_scan_frame={k: cmp[k] for k in ("close_share", "bit_equal_share",
                                                      "max_abs_err")})
        res["roofline_share"] = res["bound_ms"] / res["ms"]
        timing[name] = res
    emit("large_scene_path_timing", **timing, card=smi)

    # one K6 record launch at 1080p x 1 spp against the scan's records
    CM.reset_launches()
    acc, recs, n_trunc = path_trace_megakernel(cfg, scene, n, GRAD_SPP, record=True,
                                               return_truncated=True, device="cuda")
    torch.cuda.synchronize()
    k6_launches = CM.record_launches
    require(k6_launches == 1 and int(n_trunc[0]) == 0,
            f"large K6: {k6_launches} launches, {int(n_trunc[0])} abandoned")
    (pr, pg, pb), precs = path_trace_megakernel_plain(cfg, scene, n, GRAD_SPP, record=True)
    mism = records_equal("large 1080p record", recs, precs)
    cmp = mk_compare("large 1080p record", tuple(acc), (pr, pg, pb), GRAD_SPP, 0, 0, W)
    k6_fn = lambda: CM.megakernel_record_cuda(cfg, scene, n, GRAD_SPP)
    k6_t = time_launches({"k6": k6_fn})
    # the bound as record_timing works it out: K2's counted work at 1 spp,
    # plus the record planes written once
    *_, counts = CM.megakernel_cuda(cfg, scene, n, GRAD_SPP, counts=True)
    rec_bytes = n * GRAD_SPP * (8 + 9 * cfg.max_bounces)
    k6_bound = path_kernel_bound(scene, counts, n, 3 * 4 * n + rec_bytes, spp=GRAD_SPP)
    hit_share = float(recs[0]["hit"].float().mean())
    instance_share = float((recs[0]["hit"] & (recs[0]["inst"] > 0)).float().mean())
    k6 = {"launches": k6_launches, "record_mismatches": mism, "ms": k6_t["k6"][0],
          "ms_all": k6_t["k6"][1], **launch_device_ms(k6_fn, "megakernel_record"),
          **{k: k6_bound[k] for k in ("bound_ms", "bound_by", "bound_bytes_ms",
                                      "bound_ops_ms")},
          "roofline_share": k6_bound["bound_ms"] / k6_t["k6"][0],
          "max_abs_err": cmp["max_abs_err"],
          "bit_equal_share_vs_plain": cmp["bit_equal_share"],
          "primary_hit_share": hit_share,
          "primary_instance_hit_share": instance_share,
          "bounce_hits": int(recs[1]["hit"].sum()),
          "shadow_occluded": int(recs[1]["occ"].sum())}
    del recs, precs
    emit("large_scene_record", **k6, card=smi)
    require(hit_share >= 0.5, f"large scene: {hit_share} of primary rays hit")
    require(instance_share > 0, f"large scene: {instance_share} of primary rays hit an object")
    # S2: the bf16 node rows on the same tables
    nl5 = phase_bf16_nodes_large(cfg, binary, qb, p1, scan_sums["binary"], smi)
    # the build is shared with geomshard_check
    return {"info": info, "p1": p1, "k1": k1, "tile_ms": tile_ms, "frames": frames,
            "timing": timing, "k6": k6, "nl5": nl5, "host": s, "scene": scene}


# ------------------------------------------------- the animated frame loop

ANIM_DIR = ROOT / "build" / "animation"  # stand-ins and the CLI's outputs (git-ignored)
ANIM_FRAMES = (1000, 1003)  # frame 1000: aperture 0.4, the bunny and the dragon in view
ANIM_SPP = 64  # 8 subframes; the production preset's 1024 (128 subframes) for one frame
ANIM_CHECK_FRAMES = (1000, 1750)
ANIM_CHECK_SPP = 8  # one subframe
ANIM_SUBFRAME_SPP = (ANIM_SPP, PRODUCTION.samples_per_pixel)  # 8 and 128 subframes
# the deep CLI frame's spp: the production preset asks for 1024; cut to 128
# (16 subframes) so that the whole run stays under 600 s
ANIM_DEEP_SPP = 128
ANIM_DEEP = f"frame{ANIM_DEEP_SPP}"
CLI_TIMEOUT = 300


def stop_process_group(proc) -> None:
    """Kill a process started in a session of its own, with its children."""
    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()


def cli_start(tag, *args, out=None, metrics=True) -> dict:
    """Start ``python -m pathtracing_tpu_torch.cli`` on the stand-ins at the
    production preset, in a process of its own (its output to files beside
    its metrics); ``cli_wait`` reads it."""
    if out is None:  # a folder of its own
        out = ANIM_DIR / tag
        shutil.rmtree(out, ignore_errors=True)
    ANIM_DIR.mkdir(parents=True, exist_ok=True)
    log = ANIM_DIR / f"{tag}.jsonl"
    log.unlink(missing_ok=True)
    cmd = [sys.executable, "-m", "pathtracing_tpu_torch.cli", "--preset", "production",
           "--data-dir", str(ANIM_DIR / "standins"), "--out", str(out), *args]
    if metrics:
        cmd += ["--metrics", str(log)]
    streams = {k: ANIM_DIR / f"{tag}.{k}" for k in ("stdout", "stderr")}
    with open(streams["stdout"], "w") as fo, open(streams["stderr"], "w") as fe:
        proc = subprocess.Popen(cmd, cwd=ROOT, stdout=fo, stderr=fe, start_new_session=True)
    return {"tag": tag, "proc": proc, "t0": time.perf_counter(), "out": out, "log": log,
            "metrics": metrics, "streams": streams}


def cli_wait(run) -> dict:
    """A started CLI run to its end (its exit code required 0, killed past
    CLI_TIMEOUT): seconds since its start, the metrics lines (load and
    frames, with each frame's kernel launches) and the output folder."""
    tag, proc = run["tag"], run["proc"]
    try:
        rc = proc.wait(timeout=CLI_TIMEOUT)
    finally:
        stop_process_group(proc)
    sec = time.perf_counter() - run["t0"]
    stdout, stderr = (run["streams"][k].read_text() for k in ("stdout", "stderr"))
    require(rc == 0, f"cli {tag}: exit {rc}\n{stdout[-3000:]}\n{stderr[-3000:]}")
    out, log, metrics = run["out"], run["log"], run["metrics"]
    res = {"seconds": sec, "out": out, "stdout_tail": stdout.strip().splitlines()[-4:],
           "stdout": stdout}
    if metrics:
        lines = [json.loads(x) for x in log.read_text().splitlines()]
        load = [x for x in lines if x["kind"] == "load"]
        require(len(load) == 1 and load[0]["device"] == "cuda", f"cli {tag}: {load}")
        res.update(load=load[0], frames=[x for x in lines if x["kind"] == "frame"])
    return res


def cli_run(tag, *args, out=None, metrics=True) -> dict:
    """One CLI run, alone (see cli_start, cli_wait)."""
    return cli_wait(cli_start(tag, *args, out=out, metrics=metrics))


def cli_frames(tag, run, frames, launches, bmp=True) -> list:
    """Each frame of a CLI run: the launches its render made (``launches``,
    every other kernel 0), its BMP (1920x1080, not flat; ``bmp=False`` for a
    sample-range run, which writes partial sums instead) and its numbers."""
    zero = {"ray_query": 0, "wide_ray_query": 0, "megakernel": 0, "wavefront": 0}
    require([x["frame"] for x in run["frames"]] == list(frames), f"cli {tag}: frames")
    out = []
    for x in run["frames"]:
        require(x["launches"] == {**zero, **launches},
                f"cli {tag} frame {x['frame']}: launches {x['launches']}, want {launches}")
        if bmp:
            path = run["out"] / f"frame_{x['frame']:04d}.bmp"
            require(path.exists(), f"cli {tag}: no {path.name}")
            img = read_bmp(str(path))
            require(img.shape == (1080, 1920, 3) and float(img.std()) > 1.0,
                    f"cli {tag}: {path.name} {img.shape} std {float(img.std())}")
            x = {**x, "bmp_mean": float(img.mean())}
        out.append(x)
    return out


def trace_device_time(path, kernel) -> dict:
    """The device time of a Chrome trace written by ``utils.profiling.trace_to``
    (the CLI's ``--profile-dir``): the union of its kernel, copy and set
    intervals in ms, and the launches and summed ms of the kernels whose name
    holds ``kernel`` and of the other kernels."""
    events = [e for e in json.loads(pathlib.Path(path).read_text())["traceEvents"]
              if e.get("ph") == "X"
              and str(e.get("cat", "")).lower() in ("kernel", "gpu_memcpy", "gpu_memset")]
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    launches = [e for e in events if str(e["cat"]).lower() == "kernel"]
    mine = [float(e["dur"]) for e in launches if kernel in e["name"]]
    other = [float(e["dur"]) for e in launches if kernel not in e["name"]]
    return {"device_busy_ms": busy_us / 1e3, "kernel_launches": len(mine),
            "kernel_ms": sum(mine) / 1e3, "other_kernel_launches": len(other),
            "other_kernel_ms": sum(other) / 1e3}


def packs_equal(tag, dev, dev_cpu) -> None:
    """A frame's tables packed on the card equal the CPU's pack, byte for byte."""
    host = lambda v: v.cpu().numpy().tobytes()
    differ = [k for k in dev._fields
              if (getattr(dev, k) is None) != (getattr(dev_cpu, k) is None)
              or (getattr(dev, k) is not None
                  and host(getattr(dev, k)) != host(getattr(dev_cpu, k)))]
    require(not differ, f"{tag}: card pack vs CPU pack: {differ}")


def subframe_check(s, s_cpu, packer, packer_cpu, frame, spp) -> dict:
    """Frame ``frame`` set up at ``spp`` samples per pixel, as the CLI sets it
    up: spp / 8 subframes, each with a dynamic TLAS of its own whose exits
    chain into the static root. The card's pack equals the CPU's. On the two
    samples that straddle the last two subframes (the last of the one before
    the last, the first of the last), at 1920x1080, each within the JAX bar
    of the scan on the binary frame tables (P1) on the same samples: one K2
    launch on the chunked tables (the CLI's default), one K5 launch on the
    same tables and the row-major list, whose sums must equal K2's bit for
    bit, and one K5 launch on the binary frame tables (the CLI's
    ``--wavefront --wide 0``). These launches are checks, outside every
    counted run."""
    cfg = dataclasses.replace(PRODUCTION, samples_per_pixel=spp)
    W, H = cfg.image_width, cfg.image_height
    n = W * H
    step = cfg.samples_per_motion_blur_step
    t0 = time.perf_counter()
    setup_animation_frame(s, frame, cfg)
    dev = packer.pack_frame(s)
    torch.cuda.synchronize()
    setup_pack_s = time.perf_counter() - t0
    setup_animation_frame(s_cpu, frame, cfg)
    packs_equal(f"animation frame {frame} at {spp} spp", dev, packer_cpu.pack_frame(s_cpu))
    sub = cfg.subframe_count
    roots = {sf.tlas.node_offset for sf in s.subframes}
    require(len(s.subframes) == sub == spp // step and len(roots) == sub,
            f"frame {frame} at {spp} spp: {len(s.subframes)} subframes, {len(roots)} TLASes")
    base, k = (sub - 1) * step - 1, 2
    xs, ys = frame_pixels(cfg)
    xs_t, ys_t = torch.from_numpy(xs).cuda(), torch.from_numpy(ys).cuda()
    binary = binary_tables(dev)
    k2 = CM.megakernel_cuda(cfg, dev, n, k, sample_base=base)
    k5w = CWF.wavefront_cuda(cfg, dev, xs_t, ys_t, k, sample_base=base)
    k5b = CWF.wavefront_cuda(cfg, binary, xs_t, ys_t, k, sample_base=base)
    torch.cuda.synchronize()
    scan = torch.from_numpy(render_pixels(cfg, binary, xs, ys, spp=k, sample_base=base,
                                          average=False, megakernel=False))
    ref = tuple(scan[:, c] for c in range(3))
    require(all(torch.equal(a, b) for a, b in zip(k2[:3], k5w[:3])),
            f"frame {frame} at {spp} spp: K2 vs K5 on the chunked tables, not bit-equal")
    tag = f"animation frame {frame} at {spp} spp, samples {base}..{base + k - 1}"
    keys = ("finite_share", "close_share", "bar", "bit_equal_share", "max_abs_err")
    out = {"subframes": sub, "tlas_roots": len(roots), "sample_base": base, "samples": k,
           "subframes_walked": [base // step, (base + k - 1) // step],
           "setup_pack_s": setup_pack_s, "card_pack_equals_cpu": True,
           "k2_equals_k5_chunked": True,
           "truncated": {"k2": int(k2[4].item()), "k5_chunked": int(k5w[4].item()),
                         "k5_binary": int(k5b[4].item())}}
    for name, got in (("k2_vs_scan", k2), ("k5_binary_vs_scan", k5b)):
        cmp = mk_compare(f"{tag}: {name}", got[:3], ref, k, base, 0, W)
        out[name] = {key: cmp[key] for key in keys}
    del dev, binary, k2, k5w, k5b
    return out


def phase_animation_cli(smi):
    """The animated frame loop, the system's own main path: load_scene ->
    per frame setup_animation_frame + DevicePacker.pack_frame -> render ->
    BMP, on the reference's animated scene from stand-in meshes
    (scene/standins.py; the repo's generated terrain).
    In process, at 1920x1080 x 5 bounces x 8 spp (one subframe): the
    placement's 1,024 rays traced on the card (P1, one launch) give the
    instance list and transforms of the CPU's placement, bit for bit; for
    frames 1000 and 1750 the chunked frame tables packed on the card equal
    the CPU's pack byte for byte, the K2 frame is within the JAX bar of the
    scan frame on the binary frame tables (P1), and for frame 1000 K1 on the
    chunked tables (65,536 of its rays, the primary and first bounce batch)
    equals its plain version (ids equal, 1e-6) and P1 on the same rays; one
    K2 launch at the frames' dispatch is timed.
    Then the CLI, each run a process of its own: frames 1000-1002 at 64 spp
    with the wide tables (K2), frame 1000 at the production preset's 1024
    spp, frame 1000 at 64 spp by the wavefront on the binary frame tables
    (K5), and samples [0, 4) + [4, 8) of frame 1000 merged, which must give
    the in-process K2 frame's BMP within 1 LSB. Every run's placement
    launches P1; each frame's launches are the expected kernel's only."""
    standins = ANIM_DIR / "standins"
    t0 = time.perf_counter()
    write_standins(standins)
    write_s = time.perf_counter() - t0
    cfg = dataclasses.replace(PRODUCTION, samples_per_pixel=ANIM_CHECK_SPP)
    W, H = cfg.image_width, cfg.image_height
    n = W * H
    counters = (CT, CW, CM, CWF)

    # the placement: on the card (P1) and on the CPU
    native_build.reset_builds()
    s, load_s, load_peak, _ = frame_launches("animation load_scene", counters, {CT: 1},
                                              lambda: load_scene(str(standins), config=cfg))
    builds = dict(native_build.builds)
    t0 = time.perf_counter()
    s_cpu = load_scene(str(standins), config=cfg, device="cpu")
    cpu_load_s = time.perf_counter() - t0
    key = lambda sc: [(i.blas.node_offset, i.blas.node_count) for i in sc.instances]
    require(key(s) == key(s_cpu), "placement on the card vs the CPU: instance list")
    tf = lambda sc: np.stack([i.transform for i in sc.instances]).tobytes()
    require(tf(s) == tf(s_cpu), "placement on the card vs the CPU: transforms")
    name_of = {b.node_offset: k for k, (_, b) in s.meshes.items()}
    placed = {}
    for i in s.instances:
        placed[name_of[i.blas.node_offset]] = placed.get(name_of[i.blas.node_offset], 0) + 1
    t0 = time.perf_counter()
    packer = DevicePacker(s, wide=True, chunk_max=CHUNK_MAX)
    torch.cuda.synchronize()
    packer_s = time.perf_counter() - t0
    packer_cpu = DevicePacker(s_cpu, wide=True, chunk_max=CHUNK_MAX, device="cpu")
    load = {"standins_write_s": write_s, "load_scene_s": load_s,
            "load_scene_cpu_s": cpu_load_s, "packer_s": packer_s,
            "host_builders": builds, "instances": len(s.instances),
            "placed_by_mesh": placed, "placement_bit_equal_to_cpu": True,
            "triangles": int(sum(m.triangle_count for m, _ in s.meshes.values())),
            "peak_memory_after_load_bytes": int(load_peak)}
    emit("animation_load", **load, card=smi)

    frames = {}
    sums = lambda c: tuple(torch.from_numpy(np.ascontiguousarray(c[..., k].reshape(-1)
                                                                 * ANIM_CHECK_SPP))
                           for k in range(3))
    for frame in ANIM_CHECK_FRAMES:
        t0 = time.perf_counter()
        setup_animation_frame(s, frame, cfg)
        setup_s = time.perf_counter() - t0
        dev = packer.pack_frame(s)
        torch.cuda.synchronize()
        pack_s = time.perf_counter() - t0 - setup_s
        setup_animation_frame(s_cpu, frame, cfg)
        dev_cpu = packer_cpu.pack_frame(s_cpu)
        packs_equal(f"animation frame {frame}", dev, dev_cpu)
        tables = field_bytes(dev, BINARY_TABLES + ("wide_rows", "wide_root", "tri_shade"))
        chunk = _mk_spp_chunk(n, ANIM_CHECK_SPP, dev)
        k2_n = -(-ANIM_CHECK_SPP // chunk)
        c_k2, k2_s, k2_peak, _ = frame_launches(
            f"animation {frame} K2", counters, {CM: k2_n},
            lambda: render_frame(cfg, dev, spp=ANIM_CHECK_SPP)[0])
        binary = binary_tables(dev)
        # the scan's tiles, and the CLI's on the frame tables (below)
        tiles = -(-n // tile_pixels(binary))
        c_scan, scan_s, scan_peak, _ = frame_launches(
            f"animation {frame} scan", counters,
            {CT: tiles * ANIM_CHECK_SPP * (1 + cfg.max_bounces)},
            lambda: render_pixels(cfg, binary, *frame_pixels(cfg), spp=ANIM_CHECK_SPP,
                                  megakernel=False).reshape(H, W, 3))
        cmp = mk_compare(f"animation {frame} K2 vs scan", sums(c_k2), sums(c_scan),
                         ANIM_CHECK_SPP, 0, 0, W)
        frames[frame] = {
            "setup_s": setup_s, "pack_s": pack_s, "table_bytes": tables,
            "table_bytes_total": sum(tables.values()),
            "over_l2": {k: v / L2_BYTES for k, v in tables.items()},
            "k2": {"seconds": k2_s, "launches": k2_n, "spp_per_launch": chunk,
                   "msamples_per_s": n * ANIM_CHECK_SPP / k2_s / 1e6,
                   "peak_memory_allocated_bytes": int(k2_peak)},
            "scan_binary": {"seconds": scan_s, "msamples_per_s": n * ANIM_CHECK_SPP / scan_s / 1e6,
                            "peak_memory_allocated_bytes": int(scan_peak)},
            "k2_vs_scan": {k: cmp[k] for k in ("finite_share", "close_share", "bar",
                                               "bit_equal_share", "max_abs_err")},
        }
        if frame == ANIM_CHECK_FRAMES[0]:
            # the CLI's dispatches: the scene is large (over LARGE_SCENE_NODES
            # nodes), whatever its subframe count
            require(dev.nl8.shape[0] // 8 > LARGE_SCENE_NODES, "animated scene: not large")
            chunks = {spp: _mk_spp_chunk(n, spp, dev)
                      for spp in (ANIM_SPP, ANIM_DEEP_SPP, ANIM_CHECK_SPP // 2)}
            k2_rgb = to_bgra(c_k2)[..., [2, 1, 0]]
            t = time_launches({"k2": lambda: CM.megakernel_cuda(cfg, dev, n, chunk)})
            k2_launch = {"spp": chunk, "ms": t["k2"][0], "ms_all": t["k2"][1],
                         **launch_device_ms(lambda: CM.megakernel_cuda(cfg, dev, n, chunk),
                                            "megakernel")}
            idx = torch.arange(LARGE_BATCH, dtype=torch.int64, device="cuda") * n // LARGE_BATCH
            q = capture_queries(cfg, dev, (idx % W).to(torch.int32), (idx // W).to(torch.int32))
            k1 = [measure_wide_shape(f"animation chunked {k}", *q[i])
                  for i, k in enumerate(("primary", "bounce"))]
            del q
            # S2: one 8 spp K5 launch on the binary frame tables with bf16
            # node rows (packed on the card from the frame packer's nl8)
            # against nl8, held to the scan frame
            b5 = nl5_scene(binary, check_cpu=False)
            anim_nl5 = {"frame": frame, "tables": node_table_bytes(b5),
                        **k5_nl5_launches(f"animation {frame} K5", cfg, b5, *frame_list(cfg),
                                          ANIM_CHECK_SPP, sums(c_scan), reps=3)}
            del b5
        del c_k2, c_scan, dev, dev_cpu, binary
    emit("animation_frames", width=W, height=H, bounces=cfg.max_bounces, spp=ANIM_CHECK_SPP,
         frames=frames, k2_launch=k2_launch, card=smi)
    emit("animation_chunked_k1", batch=LARGE_BATCH, k1=k1, card=smi)
    emit("animation_nl5", **anim_nl5, card=smi)
    # the CLI runs checked for what they make and not timed, in processes of
    # their own beside the subframe checks (which take no time readings but
    # their setup's): the two sample ranges and S10's --shard (each frame
    # over this machine's cards, one tile a card, by K5 on the chunked
    # tables, one launch a card)
    f0 = str(ANIM_FRAMES[0])
    one = (f0, str(ANIM_FRAMES[0] + 1))
    parts = ANIM_DIR / "ranges"
    shutil.rmtree(parts, ignore_errors=True)
    half = ANIM_CHECK_SPP // 2
    started = {}
    for a, b in ((0, half), (half, ANIM_CHECK_SPP)):
        started[f"range_{a}_{b}"] = (
            cli_start(f"range_{a}_{b}", "--spp", str(ANIM_CHECK_SPP), "--frames", *one,
                      "--sample-range", str(a), str(b), "--wide", "1", out=parts),
            [ANIM_FRAMES[0]], {"megakernel": -(-half // chunks[half])})
    started["shard"] = (cli_start("shard", "--spp", str(ANIM_CHECK_SPP), "--frames", *one,
                                  "--shard", "--wavefront"),
                        [ANIM_FRAMES[0]], {"wavefront": torch.cuda.device_count()})
    checked = {}
    try:
        subframes = {spp: subframe_check(s, s_cpu, packer, packer_cpu, ANIM_CHECK_FRAMES[0],
                                         spp)
                     for spp in ANIM_SUBFRAME_SPP}
        emit("animation_subframes", frame=ANIM_CHECK_FRAMES[0], checks=subframes, card=smi)
        for tag, (run, want_frames, launches) in started.items():
            checked[tag] = (cli_wait(run), want_frames, launches)
    finally:
        for run, _, _ in started.values():
            stop_process_group(run["proc"])
    # S10: the hot-row permutation on the same frame; S11: the packer's
    # options and the setup without the per-subframe TLAS builds
    hot = hotperm_check(cfg, s, s_cpu, packer, smi)
    options = packer_options_check(cfg, s, s_cpu, packer, k1, smi)
    del s, s_cpu, packer, packer_cpu
    torch.cuda.empty_cache()

    # the CLI, each run a process of its own
    zero = {"ray_query": 0, "wide_ray_query": 0, "megakernel": 0, "wavefront": 0}
    profile = lambda tag: ("--profile-dir", str(ANIM_DIR / f"{tag}_profile"))
    runs = {
        "frames64": (cli_run("frames64", "--spp", str(ANIM_SPP), "--frames",
                             *map(str, ANIM_FRAMES), "--wide", "1", *profile("frames64")),
                     range(*ANIM_FRAMES), {"megakernel": -(-ANIM_SPP // chunks[ANIM_SPP])}),
        ANIM_DEEP: (cli_run(ANIM_DEEP, "--spp", str(ANIM_DEEP_SPP), "--frames", *one,
                            "--wide", "1", *profile(ANIM_DEEP)),
                    [ANIM_FRAMES[0]],
                    {"megakernel": -(-ANIM_DEEP_SPP // chunks[ANIM_DEEP_SPP])}),
        "wavefront64": (cli_run("wavefront64", "--spp", str(ANIM_SPP), "--frames", *one,
                                "--wavefront", "--wide", "0"),
                        [ANIM_FRAMES[0]], {"wavefront": tiles * -(-ANIM_SPP // chunks[ANIM_SPP])}),
    }
    runs.update(checked)
    # the merge in this process, through the CLI's entry point
    t0 = time.perf_counter()
    require(port_cli.main(["--merge", "--out", str(parts)]) == 0, "cli --merge")
    merge = {"seconds": time.perf_counter() - t0}
    merged = read_bmp(str(parts / f"frame_{ANIM_FRAMES[0]:04d}.bmp"))
    lsb = np.abs(merged.astype(np.int16) - k2_rgb.astype(np.int16))
    require(int(lsb.max()) <= 1, f"merged sample ranges vs the K2 frame: {int(lsb.max())} LSB")
    cli = {}
    for tag, (run, want_frames, launches) in runs.items():
        require(run["load"]["launches"] == {**zero, "ray_query": 1},
                f"cli {tag}: load_scene launches {run['load']['launches']}")
        fr = cli_frames(tag, run, want_frames, launches, bmp=not tag.startswith("range"))
        program_ms = [float(m.group(1)) for line in run["stdout_tail"]
                      if (m := re.search(r"FRAMES: (\d+)ms", line))]
        cli[tag] = {"seconds": run["seconds"], "load": run["load"], "frames": fr,
                    "program_ms": program_ms[0] if program_ms else None,
                    "setup_plus_render_ms": sum(x["setup_ms"] + x["render_ms"] for x in fr)}
    # the device's idle share of a K2 frame's render, from the trace that
    # --profile-dir took of the run's first frame (render_ms is timed inside
    # the trace and excludes its export)
    for tag in ("frames64", ANIM_DEEP):
        x = cli[tag]["frames"][0]
        tr = trace_device_time(ANIM_DIR / f"{tag}_profile" / "trace.json", "megakernel")
        require(tr["kernel_launches"] == x["launches"]["megakernel"],
                f"cli {tag}: traced {tr}, counted {x['launches']}")
        x["traced"] = {**tr, "idle_share": 1.0 - tr["device_busy_ms"] / x["render_ms"]}
    cli["merge"] = {"seconds": merge["seconds"], "max_lsb_vs_k2_frame": int(lsb.max()),
                    "equal_share": float((lsb == 0).mean())}
    # the sharded CLI frame (one 8 spp K5 launch a card) against the
    # in-process K2 frame (its spp chunks' sums added): within 1 LSB
    sharded = read_bmp(str(runs["shard"][0]["out"] / f"frame_{ANIM_FRAMES[0]:04d}.bmp"))
    shard_lsb = np.abs(sharded.astype(np.int16) - k2_rgb.astype(np.int16))
    require(int(shard_lsb.max()) <= 1,
            f"the --shard frame vs the K2 frame: {int(shard_lsb.max())} LSB")
    cli["shard"].update(max_lsb_vs_k2_frame=int(shard_lsb.max()),
                        equal_share_vs_k2_frame=float((shard_lsb == 0).mean()),
                        mesh_tiles=torch.cuda.device_count())
    emit("shard_cli", **cli["shard"], card=smi)
    for run in cli.values():
        for x in run.get("frames", ()):
            x["table_bytes_total"] = sum(x["table_bytes"].values())
            x["tables_over_l2"] = x["table_bytes_total"] / L2_BYTES
    emit("animation_cli", load_scene_s=load["load_scene_s"], packer_s=load["packer_s"],
         **cli, card=smi)
    return {"load": load, "frames": frames, "k1": k1, "k2_launch": k2_launch, "cli": cli,
            "subframes": subframes, "nl5": anim_nl5, "hotperm": hot, "options": options}


# ------------------------------------------------- the path kernels' designs

# The pixel orders the design timing runs each path kernel on: "row_major"
# (render_frame's one tile, the main path), "morton" (morton_pixel_order,
# K2's documented option) and "shuffled" (no two adjacent slots near each
# other on screen).
ORDER_SEED = 8  # the shuffled order's permutation


@functools.lru_cache(maxsize=None)
def order_tensor(W, H, order):
    """A W x H frame's pixel ids in ``order``, int32 on the card, or None
    for the row-major frame. Made once per order, so that a timed launch
    does not time making it on the host."""
    if order == "row_major":
        return None
    if order == "morton":
        return torch.from_numpy(morton_pixel_order(W, H)).cuda()
    gen = torch.Generator().manual_seed(ORDER_SEED)
    return torch.randperm(W * H, generator=gen).to(torch.int32).cuda()


@functools.lru_cache(maxsize=None)
def list_tensors(W, H, order):
    """The W x H frame's (xs, ys) list on the card in ``order``, made once."""
    perm = order_tensor(W, H, order)
    idx = torch.arange(W * H, dtype=torch.int32, device="cuda") if perm is None else perm
    return idx % W, idx // W


def frame_order(cfg, order):
    """The frame's pixel ids in ``order``, int32 on the card, or None for
    the row-major frame."""
    return order_tensor(cfg.image_width, cfg.image_height, order)


def frame_list(cfg, order="row_major"):
    """The 1080p frame's (xs, ys) list on the card in ``order``: row-major
    is render_frame's one tile."""
    return list_tensors(cfg.image_width, cfg.image_height, order)


def path_launch(kernel, cfg, scene, spp=MAIN_SPP, order="row_major", **kw):
    """One launch of a path kernel over the whole frame (K2: the slots, with
    ``order`` as its pixel_order; K5: the list in ``order``; K6: K2's record
    build, row-major), returning the wrapper's tuple."""
    n = cfg.image_width * cfg.image_height
    if kernel == "megakernel":
        return CM.megakernel_cuda(cfg, scene, n, spp, pixel_order=frame_order(cfg, order), **kw)
    if kernel == "megakernel_record":
        require(order == "row_major", "the record build takes no pixel order")
        return CM.megakernel_record_cuda(cfg, scene, n, spp, **kw)
    xs, ys = frame_list(cfg, order)
    return CWF.wavefront_cuda(cfg, scene, xs, ys, spp, **kw)


def phase_split(cfg, scenes, smi):
    """The phase-cycle build (csrc/path.cuh, PhaseClock) at the main path's
    shape (1080p x 8 spp): each thread's clock64() cycles per phase, summed
    over the threads, for K2 on w8 and K5 on the binary and the w8 tables, in
    the first design and in the wide block; each phase's share of the summed
    cycles. The sums of the same launch are held to the timed build's, byte
    for byte."""
    out = {}
    for kernel, kind in (("megakernel", "w8"), ("wavefront", "binary"), ("wavefront", "w8")):
        scene = scenes[kind]
        res = {}
        for design in ("first", "wide"):
            timed = path_launch(kernel, cfg, scene, _design=design)
            got = path_launch(kernel, cfg, scene, _design=design, phases=True)
            torch.cuda.synchronize()
            require(all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                        for a, b in zip(timed[:3], got[:3])),
                    f"{kernel} {kind} {design}: the phase build's sums differ")
            cyc = dict(zip(CM.PHASE_NAMES, got[5].tolist()))
            total = sum(cyc.values())
            require(total > 0 and all(v >= 0 for v in cyc.values()), f"phase cycles {cyc}")
            res[design] = {
                "cycles": cyc, "total_cycles": total,
                "share": {k: v / total for k, v in cyc.items()},
                "walk_share": (cyc["closest_walk"] + cyc["shadow_walk"]) / total,
            }
        emit("phase_split", kernel=kernel, table=kind, pixels=cfg.image_width * cfg.image_height,
             spp=MAIN_SPP, **res, card=smi)
        out[f"{kernel}_{kind}"] = res
    return out


# The design timing's cases: (path kernel, table kind, pixel order). K2 on
# the three wide layouts and K5 on the binary tables and w8, row-major as the
# main path runs them; K2 w8 in a Morton and a shuffled pixel_order and K5 on
# a shuffled list, the traffic the wrappers also take; K6 on w8.
DESIGN_CASES = (
    ("megakernel", "w8", "row_major"), ("megakernel", "w16", "row_major"),
    ("megakernel", "s8", "row_major"), ("megakernel", "w8", "morton"),
    ("megakernel", "w8", "shuffled"), ("wavefront", "binary", "row_major"),
    ("wavefront", "w8", "row_major"), ("wavefront", "binary", "shuffled"),
    ("wavefront", "w8", "shuffled"), ("megakernel_record", "w8", "row_major"),
)


def phase_design_timing(cfg, scenes, built, smi, reps=3):
    """The path kernels' two designs in this call, on this card: one launch
    of each DESIGN_CASES case at the main path's shape (1080p x 8 spp; K6 at
    1080p x 1 spp), the designs taking turns, L2 flushed before each launch;
    median and spread of ``reps``. The designs' sums are held to each
    other's, byte for byte. Each case also reports both designs' registers,
    spills, threads a block and resident blocks, and the design the wrapper
    takes."""
    out = {}
    for kernel, kind, order in DESIGN_CASES:
        scene = scenes[kind]
        spp = GRAD_SPP if kernel == "megakernel_record" else MAIN_SPP
        fns = {d: (lambda d=d: path_launch(kernel, cfg, scene, spp=spp, order=order, _design=d))
               for d in CM.DESIGNS}
        sums = {d: torch.cat([x.view(torch.int32) for x in fn()[:3]]) for d, fn in fns.items()}
        require(all(torch.equal(v, sums["first"]) for v in sums.values()),
                f"{kernel} {kind} {order}: the designs' sums differ")
        t = time_launches(fns, reps=reps)
        res = {d: {"ms": ms, "ms_all": all_ms, "spread": (min(all_ms), max(all_ms)),
                   "vs_first": ms / t["first"][0]} for d, (ms, all_ms) in t.items()}
        width = 0 if kind == "binary" else LAYOUTS[kind].w_row
        lib = CWF if kernel == "wavefront" else CM
        occ = getattr(lib.LIBRARY.load(), f"pt_{lib.LIBRARY.name}_occupancy")
        regs = built[lib.LIBRARY.name]["registers_spills_by_layout"]
        shape = {d: {"registers_spills": regs[("record_" if kernel == "megakernel_record"
                                               else "") + d][kind],
                     "block": lib.block_size(d), "blocks_per_sm": occ(width, i)}
                 for i, d in enumerate(CM.DESIGNS)}
        require(all(v["blocks_per_sm"] >= 1 for v in shape.values()), f"{kernel}: {shape}")
        emit("design_timing", kernel=kernel, table=kind, order=order, spp=spp, **res,
             shape=shape, wrapper_design=CM.DESIGN_BY_WIDTH[width], card=smi)
        out[f"{kernel}_{kind}_{order}"] = res
    return out


# ------------------------------------------------------------ the gradient path

GRAD_SPP = 1  # the frame gradient's samples per pixel: 1 spp at 1080p fits one card
SUN_STEPS = 3
SUN_LR = 0.5  # plain gradient descent on sf_light; renormalised after each step
SUN_PERTURB = np.array([0.25, -0.1, 0.2], np.float32)  # examples/inverse_fast.py's
GRAD_RTOL = 1e-5  # K7 vs its plain version: sums in another order; atol 1e-6 max|ref|


def records_equal(tag, got, ref) -> dict:
    """Two record sets (prim_rec, bounce_recs) equal, key by key, exactly.
    Returns the mismatch counts (all 0, or the check raised)."""
    out = {}
    for part, a, b in (("prim", got[0], ref[0]), ("bounce", got[1], ref[1])):
        require(a.keys() == b.keys(), f"{tag}: record keys {a.keys()} vs {b.keys()}")
        for k in a:
            require(a[k].shape == b[k].shape and a[k].dtype == b[k].dtype,
                    f"{tag}: {part}.{k} {a[k].shape} {a[k].dtype} vs {b[k].shape} {b[k].dtype}")
            out[f"{part}.{k}"] = int((a[k] != b[k]).sum())
    require(not any(out.values()), f"{tag}: record planes differ {out}")
    return out


def phase_record_check(wide_scenes, motion_wide):
    """The megakernel's record build (K6) against its plain version
    (path_trace_megakernel_plain(record=True): the scan's records, rows not
    reached zero) on the golden 640x360 frame in w8, w16, s8 and on
    motion.gold's scene, at spp 1 and spp 3 from sample 5: every record plane
    equal, the sums byte-equal to K2's (the timed build) on the same items,
    and within the JAX bar of the plain version's. The replay of K6's
    records through path_trace_samples(replay=) gives radiance bit-equal to
    the direct scan on the same items (w8, spp 1). Two launches byte-equal;
    with_stats, pixel_order and area lights raise."""
    cfg = TESTING
    n = cfg.image_width * cfg.image_height
    cases = [(name, wide_scenes[name]) for name in LAYOUTS] + [("motion_w8", motion_wide)]
    results = []
    for tag, scene in cases:
        for spp, base in ((1, 0), (3, 5)):
            (acc, recs, n_trunc) = path_trace_megakernel(
                cfg, scene, n, spp, base, record=True, return_truncated=True, device="cuda")
            (pr, pg, pb), precs = path_trace_megakernel_plain(
                cfg, scene, n, spp, base, record=True)
            r2, g2, b2, _, t2, _ = CM.megakernel_cuda(cfg, scene, n, spp, base)
            torch.cuda.synchronize()
            require(int(n_trunc[0]) == 0 and int(t2[0]) == 0, f"{tag}: samples abandoned")
            mism = records_equal(f"{tag} spp{spp}", recs, precs)
            k2_equal = all(torch.equal(a, b) for a, b in zip(acc, (r2, g2, b2)))
            require(k2_equal, f"{tag} spp{spp}: K6 sums differ from K2's")
            cmp = mk_compare(f"{tag} spp{spp}", tuple(acc), (pr, pg, pb), spp, base, 0,
                             cfg.image_width)
            results.append({"case": f"{tag} spp{spp} base{base}", "items": n * spp,
                            "record_mismatches": sum(mism.values()),
                            "sums_byte_equal_k2": k2_equal,
                            "bit_equal_share_vs_plain": cmp["bit_equal_share"],
                            "max_abs_err_vs_plain": cmp["max_abs_err"],
                            "primary_hits": int(recs[0]["hit"].sum()),
                            "bounce_hits": int(recs[1]["hit"].sum()),
                            "shadow_occluded": int(recs[1]["occ"].sum())})
    # the replay of K6's records: the direct scan's radiance, bit for bit,
    # and no walk launched
    scene = wide_scenes[MAIN_LAYOUT]
    xs, ys, si = frame_items(cfg, n, 1, 0, torch.device("cuda"))
    _, recs = path_trace_megakernel(cfg, scene, n, 1, record=True, device="cuda")
    direct = path_trace_samples(cfg, scene, xs, ys, si)
    CT.reset_launches()
    CW.reset_launches()
    replayed = path_trace_samples(cfg, scene, xs, ys, si, replay=recs)
    torch.cuda.synchronize()
    replay_walks = CT.launches + CW.launches
    replay_equal = all(torch.equal(a, b) for a, b in zip(direct, replayed))
    require(replay_equal, "the replay of K6's records differs from the direct scan")
    require(replay_walks == 0, f"the replay launched {replay_walks} walks")
    _, again = path_trace_megakernel(cfg, scene, n, 1, record=True, device="cuda")
    records_equal("two launches", again, recs)
    raised = {}
    for what, kw, exc in (("with_stats", dict(with_stats=True), ValueError),
                          ("pixel_order", dict(pixel_order=np.arange(n)), ValueError),
                          ("area_lights", dict(lit=True), NotImplementedError)):
        sc = scene._replace(lt_tris=torch.zeros((1, 9), device="cuda")) if kw.pop("lit", 0) \
            else scene
        try:
            path_trace_megakernel(cfg, sc, n, 1, record=True, device="cuda", **kw)
        except exc as e:
            raised[what] = type(e).__name__
    require(len(raised) == 3, f"record error paths: only {raised} raised")
    for r in results:
        emit("record_check", **r)
    emit("record_check", part="summary", cases=len(results),
         record_mismatches=sum(r["record_mismatches"] for r in results),
         sums_byte_equal_k2=all(r["sums_byte_equal_k2"] for r in results),
         min_bit_equal_share_vs_plain=min(r["bit_equal_share_vs_plain"] for r in results),
         replay_bit_equal_direct=replay_equal, replay_walk_launches=replay_walks,
         two_launches_byte_equal=True, error_paths_raised=raised)
    return max(r["max_abs_err_vs_plain"] for r in results)


# K7b's tables by (index columns, table columns): every shade gathers each once
ROW_TABLES = {(3, 12): "vattr", (1, 21): "inst_f", (1, 12): "tri_pos"}
# a table past what K7b sorts in one pass (12,288 rows): two passes of 8 bits
BIG_TABLE_ROWS = 49_289


def capture_gather_grads(cfg, scene, records, xs, ys, si, part):
    """The (idx, g) and (index, g) the backward kernels receive in one
    all-fields replay of the items ``part`` (a slice): the wrappers are
    wrapped to keep a copy of their inputs, and call through. Each K7b input
    is labelled by its shade (0 the primary, b the shade of bounce b) and
    table, from the forward's order of the row gathers (one of each table a
    shade): the backward gets the very index tensor the forward saved."""
    seen = {"small": [], "row": []}
    orig_s, orig_r = CG.small_table_grad_cuda, CG.row_grad_cuda
    orig_gather = integrator.row_gather
    label = {}  # data_ptr of a forward's index -> (shade, table)
    gathers = []

    def spy_gather(table, index):
        tab = ROW_TABLES[(1 if index.dim() == 1 else index.shape[1], table.shape[1])]
        gathers.append(tab)
        label[index.data_ptr()] = (gathers.count(tab) - 1, tab)
        return orig_gather(table, index)

    def spy_s(idx, g, rows):
        seen["small"].append((idx.clone(), g.clone(), rows))
        return orig_s(idx, g, rows)

    def spy_r(index, g, rows):
        seen["row"].append((*label[index.data_ptr()], index.clone(), g.clone(), rows))
        return orig_r(index, g, rows)

    CG.small_table_grad_cuda, CG.row_grad_cuda = spy_s, spy_r
    integrator.row_gather = spy_gather
    try:
        recs = ({k: v[part] for k, v in records[0].items()},
                {k: v[:, part] for k, v in records[1].items()})
        replay_value_and_grad(cfg, scene, xs[part], ys[part], si[part], recs, None,
                              DIFFERENTIABLE_FIELDS)
        torch.cuda.synchronize()
    finally:
        CG.small_table_grad_cuda, CG.row_grad_cuda = orig_s, orig_r
        integrator.row_gather = orig_gather
    shades = 1 + cfg.max_bounces
    got = sorted((sh, tab) for sh, tab, *_ in seen["row"])
    require(got == sorted((sh, tab) for sh in range(shades) for tab in ROW_TABLES.values()),
            f"K7b inputs {got}, expected each table of {shades} shades")
    return seen


def grad_compare(tag, got, ref) -> float:
    """K7 against its plain version: within rtol GRAD_RTOL, atol 1e-6 max|ref|.
    Returns the max abs error."""
    scale = float(ref.abs().max())
    err = (got - ref).abs()
    ok = bool((err <= GRAD_RTOL * ref.abs() + 1e-6 * scale).all())
    require(ok and bool(torch.isfinite(got).all() == torch.isfinite(ref).all()),
            f"{tag}: max abs err {float(err.max())} (max |ref| {scale})")
    return float(err.max())


def zero_row_share(g) -> float:
    """The share of a K7b input's cotangent rows (one per index entry) that
    are all zero (the kernel skips exact zeros)."""
    return float((g.reshape(-1, g.shape[-1]) == 0).all(-1).float().mean())


def kernel_split(fn, reps=5, want=None) -> dict:
    """Where one call of ``fn`` spends its time: the host's enqueue time
    (host clock around the call, no synchronise; median of ``reps``) and the
    device time of each kernel it launches (torch.profiler over ``reps``
    calls, each after an L2 flush by a kernel of its own name, which is left
    out; mean per call). ``want``: a kernel name the profile must hold."""
    flush = torch.empty(256 << 20, dtype=torch.int8, device="cuda")
    fn()
    host = []
    for _ in range(reps):
        flush.bitwise_not_()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        host.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    # a profile now and then comes back without its device activity, or
    # with only some of its kernels (seen after many profiles in one
    # process): up to five profiles are taken
    for _ in range(5):
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                flush.bitwise_not_()
                fn()
            torch.cuda.synchronize()
        dev, count = {}, {}
        for name, ms, n in device_kernels(prof):
            if "bitwise_not" not in name:
                dev[name[:72]] = dev.get(name[:72], 0.0) + ms / reps
                count[name[:72]] = count.get(name[:72], 0) + n
        if dev and (want is None or any(want in k for k in dev)):
            break
    require(dev, "the profiler recorded no device time")
    # a profile can also come back with only some of its launches (seen on
    # launches of 0.1 s and more): the mean of the launches it recorded
    # stands beside the sum per call
    return {"host_ms": float(np.median(host)), "host_ms_all": host,
            "device_ms": sum(dev.values()), "device_ms_by_kernel": dev,
            "launches_profiled": count,
            "device_ms_per_launch": {k: dev[k] * reps / count[k] for k in dev}}


def launch_device_ms(fn, kernel, reps=5) -> dict:
    """The device time of one launch of the kernel named ``kernel`` that
    ``fn`` launches once (the mean of the launches a profile of ``reps``
    calls recorded), how many launches it recorded, and the device time of
    fn's other kernels (the wrapper's fills and casts) per call."""
    ks = kernel_split(fn, reps, want=kernel)
    names = [k for k in ks["device_ms_per_launch"] if kernel in k]
    require(len(names) == 1, f"{kernel}: profiled {list(ks['device_ms_per_launch'])}")
    return {"device_ms": ks["device_ms_per_launch"][names[0]],
            "launches_profiled": ks["launches_profiled"][names[0]],
            "other_kernels_device_ms": sum(v for k, v in ks["device_ms_by_kernel"].items()
                                           if k != names[0])}


def device_kernels(prof) -> list:
    """(name, ms, launches) of each device kernel (and memset / copy) of a
    profile."""
    return [(e.key, getattr(e, "self_device_time_total", 0.0) / 1e3, e.count)
            for e in prof.key_averages()
            if getattr(e, "self_device_time_total", 0.0) > 0
            and "cuda" in str(getattr(e, "device_type", "")).lower()]


def phase_grad_kernel_check(cfg, scene, smi):
    """K7a and K7b against their plain versions (index_add_ in double) on
    the frame's real inputs, captured from one all-fields replay chunk of
    the 1080p frame (the shape the main path gives them; of the main path's
    chunks, the one whose primary rays hit the most triangles: sf_cam and
    sf_light for K7a, each shade's vattr, inst_f and tri_pos for K7b), and on
    seeded random inputs of the whole frame's 2,073,600 lanes with heavy
    duplication, into tables sorted in one pass and in two; two launches
    byte-equal. Then each timed (L2 flushed, median of 5) beside its plain
    version, the one PyTorch call (index_add_ in float) and, for K7a, the
    one-hot matmul of the JAX package's rule; the bound by bytes; and its
    split (kernel_split). K7b is timed on the three tables of the captured
    shade with the fewest all-zero vattr cotangent rows (a lane's row of a
    shade is non-zero only where that shade's ray hit a triangle: a miss
    lane reads row 0, and the shading takes its values from the sun
    instead), and on that tri_pos input into a table of BIG_TABLE_ROWS rows,
    which the sort takes in two passes."""
    n = cfg.image_width * cfg.image_height
    items = n * GRAD_SPP
    xs, ys, si = frame_items(cfg, n, GRAD_SPP, 0, torch.device("cuda"))
    _, records = path_trace_megakernel(cfg, scene, n, GRAD_SPP, record=True, device="cuda")
    chunk = min(items, diff_render.REPLAY_CHUNK)
    spans = [(a, min(items, a + chunk)) for a in range(0, items, chunk)]
    # triangle hits per chunk: the primary ray's, and each bounce row's
    hits = [{"items": [a, b], "primary_hits": int(records[0]["hit"][a:b].sum()),
             "bounce_hits": records[1]["hit"][:, a:b].sum(1).tolist()} for a, b in spans]
    pick = max(range(len(spans)), key=lambda i: hits[i]["primary_hits"])
    seen = capture_gather_grads(cfg, scene, records, xs, ys, si, slice(*spans[pick]))
    require(len(seen["small"]) == 2, f"captured {len(seen['small'])} K7a inputs")
    shades = {}
    for sh, tab, _, g, _ in seen["row"]:
        shades.setdefault(sh, {"hit_lanes": int(hits[pick]["primary_hits"] if sh == 0
                                                else hits[pick]["bounce_hits"][sh - 1])})
        shades[sh][f"{tab}_zero_row_share"] = zero_row_share(g)
    gen = torch.Generator(device="cuda").manual_seed(7)
    R = n
    # 80 % of the lanes on 3 hot rows, the rest spread over the table
    hot = lambda shape, hi: torch.where(
        torch.rand(shape, device="cuda", generator=gen) < 0.8,
        torch.randint(0, 3, shape, device="cuda", generator=gen),
        torch.randint(0, hi, shape, device="cuda", generator=gen)).to(torch.int32)

    def cot(shape):  # half the lanes zero, as miss lanes
        g = torch.randn(shape, device="cuda", generator=gen)
        g[torch.rand(shape[0], device="cuda", generator=gen) < 0.5] = 0.0
        return g

    S = 32  # the golden subframe tables' rows at the TESTING preset (1 here)
    small_cases = [(f"frame sf_{'cam' if g.shape[1] == 18 else 'light'}", idx, g, rows)
                   for idx, g, rows in seen["small"]]
    small_cases += [("random 2073600x18", hot((R,), S),
                     torch.randn((R, 18), device="cuda", generator=gen), S),
                    ("random 2073600x7", hot((R,), S),
                     torch.randn((R, 7), device="cuda", generator=gen), S)]
    row_cases = [(f"frame shade {sh} {tab}", i, g, rows) for sh, tab, i, g, rows in seen["row"]]
    V, T, I = (getattr(scene, k).shape[0] for k in ("vattr", "tri_pos", "inst_f"))
    # the timed shade's tri_pos transpose into a table of BIG rows: the same
    # sums, sorted in two passes over digits instead of one
    timed_shade = min(shades, key=lambda sh: shades[sh]["vattr_zero_row_share"])
    require(shades[timed_shade]["vattr_zero_row_share"] < 1.0,
            f"every captured vattr cotangent is all zero: {shades}")
    timed = {tab: (i, gg, r) for sh, tab, i, gg, r in seen["row"] if sh == timed_shade}
    timed["tri_pos_two_pass"] = (*timed["tri_pos"][:2], BIG_TABLE_ROWS)
    row_cases += [(f"frame shade {timed_shade} tri_pos, {BIG_TABLE_ROWS} rows",
                   *timed["tri_pos_two_pass"]),
                  ("random 2073600x3x12", hot((R, 3), V), cot((R, 3, 12)), V),
                  ("random 2073600x21", hot((R,), I), cot((R, 21)), I),
                  ("random 2073600x12", hot((R,), T), cot((R, 12)), T),
                  ("random 2073600x12 V=12288", hot((R,), 12288), cot((R, 12)), 12288),
                  ("random 2073600x12 V=12289", hot((R,), 12289), cot((R, 12)), 12289),
                  (f"random 2073600x12 V={BIG_TABLE_ROWS}", hot((R,), BIG_TABLE_ROWS),
                   cot((R, 12)), BIG_TABLE_ROWS)]
    lib = CG.LIBRARY.load()
    passes = {tag: lib.pt_row_grad_passes(rows) for tag, _, _, rows in row_cases}
    require(all(p == (1 if rows <= 12288 else 2) for (_, _, _, rows), p in
                zip(row_cases, passes.values())), f"K7b passes {passes}")
    errs = {"small_table_grad": [], "row_grad": []}
    for kernel, fn, plain, cases in (
            ("small_table_grad", CG.small_table_grad_cuda, integrator.small_table_grad_plain,
             small_cases),
            ("row_grad", CG.row_grad_cuda, integrator.row_grad_plain, row_cases)):
        for tag, idx, g, rows in cases:
            ref = plain(idx, g, rows)
            a = fn(idx, g, rows)
            b = fn(idx, g, rows)
            torch.cuda.synchronize()
            require(torch.equal(a, b), f"{kernel} {tag}: two launches differ")
            errs[kernel].append(grad_compare(f"{kernel} {tag}", a, ref))
    # timing at the main path's shape: the chunk's sf_cam input, and the
    # three tables of the shade whose vattr cotangent has the fewest
    # all-zero rows (tri_pos also into the big table)
    idx, g, rows = seen["small"][0] if seen["small"][0][1].shape[1] == 18 else seen["small"][1]
    # the one PyTorch call for each: index_add_ in float (and for K7a the
    # JAX rule's one-hot matmul); the plain versions add in double
    onehot = lambda: (idx.long()[:, None] == torch.arange(rows, device="cuda")[None]).float().T @ g
    index_add = lambda i, x, r: torch.zeros((r, x.shape[-1]), device="cuda").index_add_(
        0, i.reshape(-1).long(), x.reshape(-1, x.shape[-1]))
    fns = {"k7a": functools.partial(CG.small_table_grad_cuda, idx, g, rows),
           "k7a_plain": lambda: integrator.small_table_grad_plain(idx, g, rows),
           "k7a_index_add": lambda: index_add(idx, g, rows), "k7a_onehot_matmul": onehot}
    for tab, (i, gg, r) in timed.items():
        fns[f"k7b_{tab}"] = functools.partial(CG.row_grad_cuda, i, gg, r)
        fns[f"k7b_{tab}_plain"] = functools.partial(integrator.row_grad_plain, i, gg, r)
        fns[f"k7b_{tab}_index_add"] = functools.partial(index_add, i, gg, r)
    t = time_launches(fns)
    split = {k: kernel_split(fns[k]) for k in ("k7a", *(f"k7b_{tab}" for tab in timed))}
    res = {}
    for name, key, i, gg, r in (("small_table_grad", "k7a", idx, g, rows),
                                *((f"row_grad_{tab}", f"k7b_{tab}", *timed[tab])
                                  for tab in timed)):
        nbytes = i.numel() * 4 + gg.numel() * 4 + r * gg.shape[-1] * 4
        b = bound(0, nbytes, 0, gg.numel())
        res[name] = {"ms": t[key][0], "ms_all": t[key][1], **split[key],
                     "plain_ms": t[key + "_plain"][0], "library_ms": t[key + "_index_add"][0],
                     "bound_ms": b["bound_ms"], "bound_by": b["bound_by"], "bytes": nbytes,
                     "shape": f"index {tuple(i.shape)}, g {tuple(gg.shape)}, rows {r}",
                     "chunk": hits[pick]["items"], "card": smi}
        if key != "k7a":
            res[name].update(passes=lib.pt_row_grad_passes(r), timed_shade=timed_shade,
                             zero_row_share=zero_row_share(gg))
    res["small_table_grad"].update(onehot_matmul_ms=t["k7a_onehot_matmul"][0])
    emit("grad_kernel_check", part="chunks", chunk_triangle_hits=hits, captured_chunk=pick,
         shades=shades)
    for kernel in errs:
        emit("grad_kernel_check", kernel=kernel, part="checks", cases=len(errs[kernel]),
             rtol=GRAD_RTOL, atol_over_max_ref=1e-6, two_launches_byte_equal=True,
             max_abs_err=max(errs[kernel]), max_abs_err_by_case=errs[kernel],
             passes_by_case=passes if kernel == "row_grad" else None)
    for name, r in res.items():
        emit("grad_kernel_check", kernel=name, part="timing", **r)
    res["max_abs_err"] = {k: max(v) for k, v in errs.items()}
    return res


def phase_grad_slow_check(binary, wide):
    """render_value_and_grad on the card against make_fast_grad_fn on 4,096
    lanes of the golden 640x360 frame (rows 200 on, 4 bounces), binary, binary
    with bf16 node rows (S2) and w8, at tests/test_diff_fast.py's bar; the
    fast path's record pass walks with P1 (its nl5 instance on nl5 rows) /
    K1, which shows in their counts. On nl5 rows the records are nl8's, so
    the fast path's loss is bit-equal to the one on nl8."""
    cfg = TESTING
    lanes = 4096
    pix = torch.arange(lanes, dtype=torch.int32, device="cuda") + 200 * cfg.image_width
    xs, ys = pix % cfg.image_width, pix // cfg.image_width
    si = torch.zeros(lanes, dtype=torch.int32, device="cuda")
    out = {}
    for name, scene in (("binary", binary), ("binary_nl5", with_bf16_nodes(binary)),
                        ("w8", wide)):
        counts = {}
        for path, fn in (("slow", lambda: render_value_and_grad(cfg, scene, xs, ys, si)),
                         ("fast", lambda: make_fast_grad_fn(cfg)(scene, xs, ys, si))):
            for mod in (CT, CW, CG):
                mod.reset_launches()
            t0 = time.perf_counter()
            loss, grads = fn()
            torch.cuda.synchronize()
            counts[path] = {"seconds": time.perf_counter() - t0, "loss": float(loss),
                            "p1": CT.launches, "p1_by_rows": dict(CT.launches_by_rows),
                            "k1": CW.launches,
                            "k7a": CG.small_table_launches, "k7b": CG.row_launches,
                            "grads": grads}
        slow, fast = counts["slow"]["grads"], counts["fast"]["grads"]
        require(abs(counts["fast"]["loss"] - counts["slow"]["loss"])
                <= 1e-4 * abs(counts["slow"]["loss"]), f"{name}: losses differ")
        worst = {}
        for k in DIFFERENTIABLE_FIELDS:
            a, b = slow[k].double(), fast[k].double()
            scale = float(a.abs().max())
            require(bool(torch.isfinite(b).all()) and scale > 0, f"{name} {k}: not finite / zero")
            ok = bool(((b - a).abs() <= 2e-2 * a.abs() + 2e-2 * scale + 1e-9).all())
            sup = abs(int((a.abs() > 1e-12).sum()) - int((b.abs() > 1e-12).sum()))
            require(ok and sup <= 2, f"{name} {k}: fast vs slow beyond the bar (support {sup})")
            worst[k] = float(((b - a).abs() / (2e-2 * a.abs() + 2e-2 * scale + 1e-9)).max())
        walk = "k1" if name == "w8" else "p1"
        expect = 1 + cfg.max_bounces
        require(counts["fast"][walk] == expect and counts["slow"][walk] == expect,
                f"{name}: {walk} launches {counts['fast'][walk]} / {counts['slow'][walk]}, "
                f"expected {expect}")
        if name == "binary_nl5":
            require(counts["fast"]["p1_by_rows"] == {"nl8": 0, "nl5": expect},
                    f"{name}: P1 launches {counts['fast']['p1_by_rows']}")
            require(counts["fast"]["loss"] == out["binary"]["fast"]["loss"],
                    f"{name}: the fast loss differs from nl8's")
        for c in counts.values():
            c.pop("grads")
        out[name] = counts
        emit("grad_slow_check", scene=name, lanes=lanes, bounces=cfg.max_bounces,
             bar="rtol 2e-2, atol 2e-2 max|ref|, support within 2", worst_err_over_bar=worst,
             **counts)
    return out


def phase_record_timing(cfg, scene, smi):
    """One K6 launch at the main path's shape (the 1080p frame, GRAD_SPP spp:
    make_fast_grad_frame_fn's record pass), timed in turns with K2's timed
    build on the same items (L2 flushed, median of 3); the plain version's
    time (the scan with records, host clock to a synchronise) and its
    result, which K6's records of the same call must equal on every plane,
    with K6's sums byte-equal to K2's and within the JAX bar of the plain
    version's (their max abs error is the kernels line's); the bound: K2's
    from the counting build's counters of the same work, plus the record
    planes' bytes written once."""
    n = cfg.image_width * cfg.image_height
    t = time_launches({"k6": lambda: CM.megakernel_record_cuda(cfg, scene, n, GRAD_SPP),
                       "k2": lambda: CM.megakernel_cuda(cfg, scene, n, GRAD_SPP)}, reps=3)
    *_, counts = CM.megakernel_cuda(cfg, scene, n, GRAD_SPP, counts=True)
    items = n * GRAD_SPP
    rec_bytes = items * 8 + cfg.max_bounces * items * 9
    res = path_kernel_bound(scene, counts, n, 3 * 4 * n + rec_bytes, spp=GRAD_SPP)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (pr, pg, pb), precs = path_trace_megakernel_plain(cfg, scene, n, GRAD_SPP, record=True)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    acc, recs, n_trunc = path_trace_megakernel(
        cfg, scene, n, GRAD_SPP, record=True, return_truncated=True, device="cuda")
    r2, g2, b2, _, t2, _ = CM.megakernel_cuda(cfg, scene, n, GRAD_SPP)
    torch.cuda.synchronize()
    require(int(n_trunc[0]) == 0 and int(t2[0]) == 0, "1080p record: samples abandoned")
    mism = records_equal("1080p record", recs, precs)
    k2_equal = all(torch.equal(a, b) for a, b in zip(acc, (r2, g2, b2)))
    require(k2_equal, "1080p record: K6 sums differ from K2's")
    cmp = mk_compare("1080p record", tuple(acc), (pr, pg, pb), GRAD_SPP, 0, 0, cfg.image_width)
    res.update(ms=t["k6"][0], ms_all=t["k6"][1], k2_ms_same_call=t["k2"][0],
               k2_ms_all=t["k2"][1], plain_ms=plain_ms, record_bytes=rec_bytes,
               roofline_share=res["bound_ms"] / t["k6"][0],
               record_mismatches=mism, sums_byte_equal_k2=k2_equal,
               bit_equal_share_vs_plain=cmp["bit_equal_share"],
               max_abs_err=cmp["max_abs_err"], primary_hits=int(recs[0]["hit"].sum()),
               bounce_hits=int(recs[1]["hit"].sum()), shadow_occluded=int(recs[1]["occ"].sum()),
               card=smi)
    emit("record_timing", **res)
    return res


def split_step(cfg, n, scene):
    """One all-fields step through make_fast_grad_frame_fn, timed by its
    pieces: the record pass, the replays without autograd and under autograd
    (path_trace_samples in diff/render, told apart by whether autograd is
    on) and the backwards (the torch.autograd.grad calls given a cotangent;
    the one without is the loss's cotangent per lane), each wrapped to time
    it on the host's clock between two synchronises, and the whole step.
    Returns (seconds by piece, the step's loss)."""
    split = {}

    def timed(name, fn):
        def run(*a, **k):
            key = name(a, k) if callable(name) else name
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            split[key] = split.get(key, 0.0) + time.perf_counter() - t0
            return out
        return run

    orig = {"rec": mk_module.path_trace_megakernel, "pts": diff_render.path_trace_samples,
            "grad": torch.autograd.grad}
    mk_module.path_trace_megakernel = timed("k6_record", orig["rec"])
    diff_render.path_trace_samples = timed(
        lambda a, k: "replay_autograd" if torch.is_grad_enabled() else "replay_no_grad",
        orig["pts"])
    torch.autograd.grad = timed(
        lambda a, k: "backward" if (a[2:3] or [k.get("grad_outputs")])[0] is not None
        else "loss_cotangent",
        orig["grad"])
    try:
        loss, _ = timed("step", make_fast_grad_frame_fn(cfg, n, GRAD_SPP))(scene)
    finally:
        mk_module.path_trace_megakernel = orig["rec"]
        diff_render.path_trace_samples = orig["pts"]
        torch.autograd.grad = orig["grad"]
    require(set(split) == {"k6_record", "replay_no_grad", "loss_cotangent", "replay_autograd",
                           "backward", "step"}, f"split step pieces {sorted(split)}")
    return split, loss


def profile_replay_chunk(cfg, scene) -> dict:
    """One all-fields replay chunk of the 1080p frame (the last
    REPLAY_CHUNK items, the bottom rows, where the geometry is) and its
    backward under torch.profiler (device activity only): its device time
    by kernel, the gather transposes' share (K7a stg_*, K7b rowg_*), and no
    device kernel whose name holds indexing_backward."""
    n = cfg.image_width * cfg.image_height
    items = n * GRAD_SPP
    part = slice(max(0, items - diff_render.REPLAY_CHUNK), items)
    xs, ys, si = frame_items(cfg, n, GRAD_SPP, 0, torch.device("cuda"))
    _, (prim, bounce) = path_trace_megakernel(cfg, scene, n, GRAD_SPP, record=True,
                                              device="cuda")
    recs = ({k: v[part] for k, v in prim.items()}, {k: v[:, part] for k, v in bounce.items()})
    run = lambda: replay_value_and_grad(cfg, scene, xs[part], ys[part], si[part], recs, None,
                                        DIFFERENTIABLE_FIELDS)
    run()
    torch.cuda.synchronize()
    CG.reset_launches()
    t0 = time.perf_counter()
    # device activity only: the chunk's ~10^5 host-side op events are not
    # read, and gathering them took the profile ~20 s
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    dev = sorted(device_kernels(prof), key=lambda r: -r[1])
    busy = sum(ms for _, ms, _ in dev)
    index_bwd = [(k[:80], ms) for k, ms, _ in dev if "indexing_backward" in k]
    k7 = sum(ms for k, ms, _ in dev if "stg_" in k or "rowg_" in k)
    require(not index_bwd, f"the replay chunk's backward ran {index_bwd}")
    require(CG.row_launches == 3 * (1 + cfg.max_bounces) and CG.small_table_launches == 2,
            f"profiled chunk: {CG.small_table_launches} K7a, {CG.row_launches} K7b launches")
    return {"items": [part.start, part.stop], "profiled_wall_ms": wall_ms,
            "device_busy_ms": busy, "device_idle_share_profiled": 1.0 - busy / wall_ms,
            "indexing_backward_ms": 0.0, "gather_grad_kernels_ms": k7,
            "gather_grad_share_of_busy": k7 / busy,
            "top_kernels": [{"name": k[:80], "ms": ms} for k, ms, _ in dev[:8]]}


def phase_main_path_grad(cfg, scene, smi):
    """The gradient path at full width: make_fast_grad_frame_fn on the
    1920x1080 frame, 5 bounces, GRAD_SPP spp, the w8 golden scene. One step
    with every field (finite loss; finite, non-zero gradients on every
    field), then SUN_STEPS steps of inverse sun (examples/inverse_fast.py:
    target = K2 under the true sun, mean squared error, the sun perturbed by
    SUN_PERTURB, plain gradient descent at SUN_LR, renormalised), whose sun
    error must fall. The counts are set to 0 just before the first step and
    read just after the last: K6 once a step; K7a twice (sf_cam, sf_light)
    per replay chunk in the all-fields step and once in a sun step; K7b
    3 (1 + max_bounces) times per chunk (vattr, inst_f and tri_pos of each
    shade), only in the all-fields step; no P1, K1, K2 or K5. Then the
    all-fields step once more, warm (what each step of a training loop
    pays; the first step also pays first calls), timed whole and by its
    pieces (split_step); and one replay chunk under the profiler
    (profile_replay_chunk), whose backward must run no indexing_backward
    kernel: every gather of a differentiable table transposes on K7a or
    K7b."""
    n = cfg.image_width * cfg.image_height
    dev = torch.device("cuda")
    chunks = -(-n * GRAD_SPP // diff_render.REPLAY_CHUNK)
    acc = path_trace_megakernel(cfg, scene, n, GRAD_SPP, device="cuda")
    target = torch.stack(list(acc), -1) / GRAD_SPP
    idx = torch.arange(n * GRAD_SPP, device=dev) % n

    def mse(c):
        return torch.mean((torch.stack(list(c), -1) - target[idx]) ** 2)

    counters = (CT, CW, CM, CWF, CG)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mod in counters:
        mod.reset_launches()
    all_fn = make_fast_grad_frame_fn(cfg, n, GRAD_SPP)
    t0 = time.perf_counter()
    loss, grads = all_fn(scene)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    all_counts = {"k6": CM.record_launches, "k7a": CG.small_table_launches,
                  "k7b": CG.row_launches, "p1": CT.launches, "k1": CW.launches,
                  "k2": CM.launches, "k5": CWF.launches}
    peak = torch.cuda.max_memory_allocated()
    require(bool(torch.isfinite(loss)), f"all-fields loss {float(loss)}")
    stats = {}
    for k in DIFFERENTIABLE_FIELDS:
        g = grads[k]
        require(g.shape == getattr(scene, k).shape, f"{k}: gradient shape {g.shape}")
        require(bool(torch.isfinite(g).all()), f"{k}: non-finite gradient on the full frame")
        nz = int((g != 0).sum())
        require(nz > 0, f"{k}: all-zero gradient on the full frame")
        stats[k] = {"nonzero": nz, "max_abs": float(g.abs().max())}
    want = {"k6": 1, "k7a": 2 * chunks, "k7b": 3 * (1 + cfg.max_bounces) * chunks,
            "p1": 0, "k1": 0, "k2": 0, "k5": 0}
    require(all_counts == want, f"all-fields step launches {all_counts}, expected {want}")

    # inverse sun
    norm = lambda v: v / np.linalg.norm(v)
    sf0 = scene.sf_light.cpu().numpy()
    true_dir = sf0[0, 0:3].copy()
    bad = sf0.copy()
    bad[0, 0:3] = norm(true_dir + SUN_PERTURB)
    cur = scene._replace(sf_light=torch.from_numpy(bad).to(dev))
    err = lambda v: float(np.degrees(np.arccos(np.clip(np.dot(norm(v), norm(true_dir)), -1, 1))))
    sun_fn = make_fast_grad_frame_fn(cfg, n, GRAD_SPP, fields=("sf_light",), loss_fn=mse)
    errs, losses, secs = [err(bad[0, 0:3])], [], []
    for _ in range(SUN_STEPS):
        t0 = time.perf_counter()
        sl, sg = sun_fn(cur)
        g = sg["sf_light"].cpu().numpy()
        secs.append(time.perf_counter() - t0)
        require(np.isfinite(g).all() and np.isfinite(float(sl)), "inverse sun: not finite")
        nxt = cur.sf_light.cpu().numpy() - SUN_LR * g
        nxt[:, 0:3] = norm(nxt[0, 0:3])
        cur = cur._replace(sf_light=torch.from_numpy(nxt.astype(np.float32)).to(dev))
        losses.append(float(sl))
        errs.append(err(nxt[0, 0:3]))
    total = {"k6": CM.record_launches, "k7a": CG.small_table_launches,
             "k7b": CG.row_launches, "p1": CT.launches, "k1": CW.launches,
             "k2": CM.launches, "k5": CWF.launches}
    want_total = {"k6": 1 + SUN_STEPS, "k7a": 2 * chunks + SUN_STEPS * chunks,
                  "k7b": 3 * (1 + cfg.max_bounces) * chunks, "p1": 0, "k1": 0, "k2": 0,
                  "k5": 0}
    require(total == want_total, f"main path launches {total}, expected {want_total}")
    require(errs[-1] < errs[0], f"the sun error did not fall: {errs}")

    # the all-fields step again, warm (what each step of a training loop
    # pays), timed whole and by its pieces
    split, split_loss_s = split_step(cfg, n, scene)
    warm_s = split["step"]
    require(float(split_loss_s) == float(loss),
            f"the warm step's loss {float(split_loss_s)} != {float(loss)}")
    profiled = profile_replay_chunk(cfg, scene)
    res = {"width": cfg.image_width, "height": cfg.image_height, "bounces": cfg.max_bounces,
           "spp": GRAD_SPP, "items": n * GRAD_SPP, "replay_chunk": diff_render.REPLAY_CHUNK,
           "chunks": chunks, "loss": float(loss), "grad_stats": stats,
           "all_fields_step_seconds": step_s, "all_fields_warm_step_seconds": warm_s,
           "all_fields_launches": all_counts,
           "split_seconds": split, "split_sum_seconds": sum(v for k, v in split.items()
                                                            if k != "step"),
           "peak_memory_allocated_bytes": int(peak), "sun_lr": SUN_LR,
           "sun_perturb": SUN_PERTURB.tolist(), "sun_error_deg": errs, "sun_losses": losses,
           "sun_step_seconds": secs, "launches": total, "profiled_chunk": profiled,
           "card": smi}
    emit("main_path_grad", **res)
    return res, (loss, grads)


# ------------------------------------------------------------ area lights

LIGHT_DIR = ROOT / "build" / "arealights"  # the generated panel scene (git-ignored)
# the light checks' frame: 640x360 at the production preset's 5 bounces
LIGHT_CFG = dataclasses.replace(PRODUCTION, image_width=640, image_height=360,
                                samples_per_pixel=MAIN_SPP)
PANEL_GRID = 6  # quads a side of the emissive panel: 72 triangles an instance
CORNELL_SPP = 64  # the Cornell box's CLI frames
CORNELL_ADAPTIVE_BASE = 8  # the adaptive CLI frame's first pass
# the in-process pass 2 on a 640x360 list: samples [0, 2) everywhere, then 2
# more a pixel on average where the variance is (buckets up to 16 extra)
ADAPTIVE_LIST_SPP = (2, 4)
DENOISE_RADII = (2, 4)
DENOISE_RTOL = 1e-5  # K8 vs its plain version on the card; atol 1e-6 max|ref|
# K8's float operations a tap and a pixel, counted from csrc/denoise.cu's
# first design (each exp one): spatial 2, albedo 12, normal 10, depth 7,
# coverage 4, range 12, sums 7; the centre's luminance, the denominators and
# the division 14
DENOISE_TAP_FLOPS, DENOISE_PIXEL_FLOPS = 54, 14
# inputs (colours, albedo, normal 3 x 12, depth, coverage, noise 3 x 4) and
# output (12) bytes a pixel
DENOISE_PIXEL_BYTES = 60
# K8's edge cases on seeded random guides (H, W, radius): shapes that are no
# multiple of the tile, a radius of 0, 1 and past a 5 x 7 image; None is
# the first radius whose tile and halo do not fit a block's shared memory
DENOISE_EDGE = ((1, 1, 2), (7, 1000, 2), (1081, 1921, 2), (5, 7, 0), (5, 7, 1), (5, 7, 9),
                (5, 7, None), (64, 96, None))
# and one of extreme values (zero noise, depths of 1e25 and 1e-30, albedo and
# colours equal or an ulp apart, colours of 1e-30)
DENOISE_EXTREME = (67, 131, 2)


def write_panel_scene(d, n=PANEL_GRID) -> None:
    """tests/test_arealights.py's panel scene with the 8 x 8 panel cut into
    an n x n grid of quads (2 n^2 emissive triangles), so that a light
    sample's search of lt_cdf runs several levels: g.obj, p.obj, m.mtl."""
    d.mkdir(parents=True, exist_ok=True)
    (d / "g.obj").write_text(
        "mtllib m.mtl\nusemtl g\nv -20 0 -20\nv 20 0 -20\nv 20 0 20\nv -20 0 20\n"
        "vn 0 1 0\nf 1//1 2//1 3//1\nf 1//1 3//1 4//1\n")
    v = lambda i, j: j * (n + 1) + i + 1
    verts = "".join(f"v {-4 + 8 * i / n} 6 {-4 + 8 * j / n}\n"
                    for j in range(n + 1) for i in range(n + 1))
    faces = "".join(f"f {v(i, j)}//1 {v(i + 1, j + 1)}//1 {v(i + 1, j)}//1\n"
                    f"f {v(i, j)}//1 {v(i, j + 1)}//1 {v(i + 1, j + 1)}//1\n"
                    for j in range(n) for i in range(n))
    (d / "p.obj").write_text(f"mtllib m.mtl\nusemtl light\n{verts}vn 0 -1 0\n{faces}")
    (d / "m.mtl").write_text("newmtl g\nKd 0.6 0.6 0.6\nPr 0.8\n"
                             "newmtl light\nKd 3 3 3\nKe 3 3 3\nPr 1.0\n")


def panel_scene(cfg, device="cuda", wide=True):
    """The panel scene with its light tables: the ground, the panel scaled
    x2 and a second panel beside it (144 light rows), and a sun, so that both
    NEE terms add."""
    write_panel_scene(LIGHT_DIR)
    b = SceneBuilder()
    b.add_mesh("g", str(LIGHT_DIR / "g.obj"))
    b.add_mesh("p", str(LIGHT_DIR / "p.obj"))
    b.add_instance("g")
    b.add_instance("p", scale=(2, 1, 1))
    b.add_instance("p", pos=(10, 1, -5))
    b.set_camera(position=(0, 2.0, 12.0), pitch_yaw_roll=(8, 0, 0), fov=50)
    b.set_light(direction=(0.3, 1, 0.2), color=(1, 1, 1))
    return b.build(cfg, emissive_nee=True, wide=wide, device=device)[1]


def phase_arealight_check(smi):
    """The path kernels' area-light instances against their plain versions
    (the scan's sample-ordered sums, on the card) on the Cornell box and on
    the panel scene at 640x360 x 5 bounces: K2 on w8 over the row-major
    frame, K5 on the binary and the w8 tables over a random list with
    duplicates; spp 1 from sample 0 and spp 4 from sample 5 with the lum^2
    plane; each launch counted on its kernel; two launches byte-equal; the
    counting build's light samples and light pdfs. Then the scan with
    lights on the card against the CPU's on 4,096 lanes of each scene."""
    cfg = LIGHT_CFG
    W, H = cfg.image_width, cfg.image_height
    n = W * H
    scenes = {"cornell": models.build("cornell_box", cfg, wide=True, device="cuda")[1],
              "panel": panel_scene(cfg)}
    require(scenes["panel"].lt_tris.shape[0] >= 64, "the panel scene's light rows")
    rng = np.random.default_rng(ORDER_SEED)
    xs_np = rng.integers(0, W, n).astype(np.int32)
    ys_np = rng.integers(0, H, n).astype(np.int32)
    xs, ys = torch.from_numpy(xs_np).cuda(), torch.from_numpy(ys_np).cuda()
    cases, counts, max_err = [], {}, {"megakernel": 0.0, "wavefront": 0.0}
    for name, s in scenes.items():
        kinds = {"binary": binary_tables(s), "w8": s}
        for spp, base in ((1, 0), (4, 5)):
            stats = spp > 1
            CM.reset_launches()
            res, _ = mk_case(f"{name} K2 w8", cfg, s, n, spp, base, with_stats=stats)
            require(CM.launches == 1, f"{name} K2: {CM.launches} launches")
            for r in res:
                emit("arealight_check", scene=name, **r)
            cases += res
            max_err["megakernel"] = max(max_err["megakernel"], *(r["max_abs_err"] for r in res))
            for kind, sc in kinds.items():
                CWF.reset_launches()
                res, _ = wf_case(f"{name} K5 {kind}", cfg, sc, xs, ys, spp, base,
                                 with_stats=stats)
                require(CWF.launches == 1, f"{name} K5 {kind}: {CWF.launches} launches")
                for r in res:
                    emit("arealight_check", scene=name, **r)
                cases += res
                max_err["wavefront"] = max(max_err["wavefront"],
                                           *(r["max_abs_err"] for r in res))
        twice = {
            "k2_w8": lambda: CM.megakernel_cuda(cfg, s, n, 4, 5, with_stats=True),
            "k5_binary": lambda: CWF.wavefront_cuda(cfg, kinds["binary"], xs, ys, 4, 5,
                                                    with_stats=True),
            "k5_w8": lambda: CWF.wavefront_cuda(cfg, s, xs, ys, 4, 5, with_stats=True),
        }
        for tag, fn in twice.items():
            a, b = fn(), fn()
            require(all(x.cpu().numpy().tobytes() == y.cpu().numpy().tobytes()
                        for x, y in zip(a[:4], b[:4])), f"{name} {tag}: two launches differ")
        *_, cnt = CM.megakernel_cuda(cfg, s, n, 1, counts=True)
        c = dict(zip(CM.COUNT_NAMES, cnt.tolist()))
        require(c["light_samples"] > 0 and c["light_pdfs"] > 0,
                f"{name}: the light instance counted {c}")
        counts[name] = c
        emit("arealight_check", scene=name, lights=int(s.lt_tris.shape[0]), counts=c,
             two_launches_byte_equal=True)
    # the scan with lights, the card's against the CPU's
    scan = {}
    lanes = 4096
    idx = np.random.default_rng(ORDER_SEED + 1).integers(0, n, lanes).astype(np.int32)
    cpu = {"cornell": models.build("cornell_box", cfg, wide=False, device="cpu")[1],
           "panel": panel_scene(cfg, device="cpu", wide=False)}
    for name, sc in cpu.items():
        args = lambda d: [torch.from_numpy(a).to(d) for a in (idx % W, idx // W, idx % 7 + 3)]
        ref = path_trace_samples(cfg, sc, *args("cpu"))
        got = path_trace_samples(cfg, binary_tables(scenes[name]), *args("cuda"))
        scan[name] = mk_compare(f"{name} scan, card vs CPU", tuple(got), tuple(ref), 1, 3, 0,
                                W, xy=(idx % W, idx // W))
        emit("arealight_check", scene=name, **scan[name])
    return {"cases": cases, "max_abs_err": max_err, "counts": counts, "scan": scan,
            "lights": {k: int(s.lt_tris.shape[0]) for k, s in scenes.items()}, "card": smi}


def cornell_scene(spp=CORNELL_SPP):
    """The Cornell box at the production preset's 1920x1080 x 5 bounces,
    packed for ``spp`` samples, wide and light tables, on the card."""
    cfg = dataclasses.replace(PRODUCTION, samples_per_pixel=spp)
    return cfg, models.build("cornell_box", cfg, wide=True, device="cuda")[1]


def phase_arealight_timing(smi):
    """One launch of each path kernel's area-light instance on the Cornell
    box at 1080p x 8 spp (K2 on w8, K5 on w8 and on the binary tables; L2
    flushed, median of 3 in turns), its device time, and its bound from the
    counting build's counters of the same work; the plain version (the
    scan) on the same work once."""
    cfg, s = cornell_scene(MAIN_SPP)
    n = cfg.image_width * cfg.image_height
    xs, ys = frame_list(cfg)
    binary = binary_tables(s)
    fns = {
        "k2_w8": lambda: CM.megakernel_cuda(cfg, s, n, MAIN_SPP),
        "k5_w8": lambda: CWF.wavefront_cuda(cfg, s, xs, ys, MAIN_SPP),
        "k5_binary": lambda: CWF.wavefront_cuda(cfg, binary, xs, ys, MAIN_SPP),
    }
    t = time_launches(fns, reps=3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = path_trace_wavefront_plain(cfg, binary, xs, ys, MAIN_SPP)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    k2 = CM.megakernel_cuda(cfg, s, n, MAIN_SPP)
    err = float(max((a - b).abs().max() for a, b in zip(k2[:3], plain[:3])))
    out = {"plain_ms": plain_ms, "k2_vs_plain_max_abs_err": err}
    for tag, fn in fns.items():
        kernel = "megakernel" if tag.startswith("k2") else "wavefront"
        scene = binary if tag.endswith("binary") else s
        dev_ms = launch_device_ms(fn, kernel)
        cnt = (CM.megakernel_cuda(cfg, s, n, MAIN_SPP, counts=True) if kernel == "megakernel"
               else CWF.wavefront_cuda(cfg, scene, xs, ys, MAIN_SPP, counts=True))[-1]
        io = 3 * 4 * n if kernel == "megakernel" else (2 * 4 + 3 * 4) * n
        res = path_kernel_bound(scene, cnt, n, io)
        require(res["counts"]["samples"] == n * MAIN_SPP, f"{tag}: counted {res['counts']}")
        res.update(kernel=tag, ms=t[tag][0], ms_all=t[tag][1], **dev_ms,
                   roofline_share=res["bound_ms"] / t[tag][0], plain_ms=plain_ms, card=smi)
        emit("arealight_timing", **res)
        out[tag] = res
    return out


def phase_cornell_cli(smi):
    """The Cornell box through the CLI at 1920x1080 x 5 bounces x 64 spp
    (its default area lights), in processes of its own: by K2 (w8, the
    default on the card) and with --wavefront by K5 (w8); each run's launches
    (that kernel's only, one a dispatch of _mk_spp_chunk's spp), seconds,
    Msamples/s, peak memory; the two BMPs equal (K5 on the row-major list is
    K2's sums, bit for bit)."""
    cfg, s = cornell_scene()
    n = cfg.image_width * cfg.image_height
    chunks = -(-CORNELL_SPP // _mk_spp_chunk(n, CORNELL_SPP, s))
    runs = {}
    for tag, kernel, extra in (("cornell64", "megakernel", ()),
                               ("cornell64_wavefront", "wavefront", ("--wavefront",))):
        run = cli_run(tag, "--model", "cornell_box", "--spp", str(CORNELL_SPP), *extra)
        frames = cli_frames(tag, run, [0], {kernel: chunks})
        runs[tag] = {"seconds": run["seconds"], "frame": frames[0],
                     "launches": frames[0]["launches"][kernel],
                     "load_ms": run["load"]["load_ms"]}
        emit("cornell_cli", run=tag, kernel=kernel, **runs[tag], card=smi)
    a, b = (read_bmp(str(ANIM_DIR / t / "frame_0000.bmp")) for t in runs)
    require((a == b).all(), "cornell CLI: the K5 frame differs from the K2 frame")
    return runs


def phase_adaptive_cli(smi):
    """The adaptive workflow through the CLI on the Cornell box at 1080p x 5
    bounces: --adaptive 8 --spp 64 --aovs --wavefront (pass 1 by K2 with its
    lum^2 plane, pass 2 by K5 per bucket of equal extra counts, the AOV pass
    by K1): pass 1, pass 2 and the AOV pass's ms, launches, the samples per
    pixel, the AOV file. Then, for the open choice of render_pixels' pick on
    lists that are not row-major, pass 2 on a 640x360 frame in process
    (ADAPTIVE_LIST_SPP, the scene packed for 64 spp: the buckets are not
    row-major lists), by K5 and by the scan (K1), the same buckets: seconds
    and launches, and the two frames against each other. (The CLI's frame
    is packed for its own 64 spp, so its cap of 56 extra samples is every
    pixel's share: pass 2 is one row-major bucket, as in the JAX CLI.)"""
    run = cli_run("cornell_adaptive", "--model", "cornell_box", "--spp", str(CORNELL_SPP),
                  "--adaptive", str(CORNELL_ADAPTIVE_BASE), "--aovs", "--wavefront")
    require(len(run["frames"]) == 1, "adaptive CLI: one frame")
    fr = run["frames"][0]
    la = fr["launches"]
    require(la["megakernel"] == 1 and la["wavefront"] >= 1 and la["ray_query"] == 0
            and la["wide_ray_query"] == min(CORNELL_SPP, 8), f"adaptive CLI launches {la}")
    line = [x for x in run["stdout"].splitlines() if "adaptive samples/pixel" in x]
    require(len(line) == 1, f"adaptive CLI: no samples line in {run['stdout'][-2000:]}")
    out_dir = ANIM_DIR / "cornell_adaptive"
    require((out_dir / "frame_0000.bmp").exists(), "adaptive CLI: no BMP")
    aovs = np.load(out_dir / "frame_0000.aovs.npz")
    require(sorted(aovs.files) == ["albedo", "coverage", "depth", "normal"]
            and aovs["albedo"].shape == (1080, 1920, 3) and aovs["depth"].shape == (1080, 1920),
            f"adaptive CLI: AOV file {aovs.files}")
    cli = {"seconds": run["seconds"], "render_ms": fr["render_ms"],
           "pass1_ms": fr["pass1_ms"], "pass2_ms": fr["pass2_ms"], "aov_ms": fr["aov_ms"],
           "launches": la, "peak_memory_allocated_bytes": fr["peak_memory_allocated_bytes"],
           "samples_line": line, "coverage_mean": float(aovs["coverage"].mean())}
    emit("adaptive_cli", **cli, card=smi)
    # pass 2 on a 640x360 list: K5 against the scan
    cfg = dataclasses.replace(LIGHT_CFG, samples_per_pixel=CORNELL_SPP)
    s = models.build("cornell_box", cfg, wide=True, device="cuda")[1]
    W, H = cfg.image_width, cfg.image_height
    idx = np.arange(W * H, dtype=np.int32)
    res = {}
    counters = (CT, CW, CM, CWF)
    for tag, wf in (("k5", True), ("scan", False)):
        timings = {}
        for mod in counters:
            mod.reset_launches()
        colors, spp_px = render_adaptive(cfg, s, idx % W, idx // W, *ADAPTIVE_LIST_SPP,
                                         wavefront=wf, device="cuda", timings=timings)
        res[tag] = {"pass1_s": timings["pass1_s"], "pass2_s": timings["pass2_s"],
                    "launches": {m.__name__.rsplit(".", 1)[-1]: m.launches for m in counters},
                    # the extra counts of pass 2, one launch each on K5
                    "buckets": int(len(np.unique(spp_px[spp_px > ADAPTIVE_LIST_SPP[0]]))),
                    "colors": colors,
                    "samples_mean": float(spp_px.mean())}
    buckets = res["k5"]["buckets"]
    la, lb = res["k5"]["launches"], res["scan"]["launches"]
    require(buckets > 1 and la["cuda_megakernel"] == lb["cuda_megakernel"] == 1
            and la["cuda_wavefront"] == buckets and lb["cuda_wavefront"] == 0
            and lb["cuda_wide_traversal"] > 0, f"adaptive pass 2: {res}")
    cmp = mk_compare("adaptive 640x360, K5 pass 2 vs scan pass 2",
                     tuple(torch.from_numpy(res["k5"]["colors"][:, k]) for k in range(3)),
                     tuple(torch.from_numpy(res["scan"]["colors"][:, k]) for k in range(3)),
                     CORNELL_SPP, 0, 0, W)
    for r in res.values():
        r.pop("colors")
    emit("adaptive_pass2", **res, vs_scan=cmp, card=smi)
    return {"cli": cli, "pass2_640x360": res, "k5_vs_scan": cmp}


def denoise_bound(n: int, radius: int) -> dict:
    taps = (2 * radius + 1) ** 2
    return bound(0, DENOISE_PIXEL_BYTES * n, 0,
                 n * (DENOISE_TAP_FLOPS * taps + DENOISE_PIXEL_FLOPS))


def denoise_random_guides(H: int, W: int, seed: int = 0, extreme: bool = False):
    """Seeded random guides on the card, as tests/test_torch_denoise.py
    makes them (random albedo and unit normals: no factor is exactly 1):
    colors, albedo, normal, depth, coverage and the noise map. ``extreme``:
    zero noise on a quarter of the pixels; on an eighth each, depths of 1e25
    and of 1e-30, albedo of 0.5 and an ulp above it, colours of 1e-30 and
    1.5e-30."""
    rng = np.random.default_rng(seed)
    nrm = rng.normal(size=(H, W, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    colors = rng.gamma(1.0, 0.5, (H, W, 3)).astype(np.float32)
    albedo = rng.random((H, W, 3), np.float32)
    depth = (rng.random((H, W), np.float32) * 5).astype(np.float32)
    coverage = (rng.random((H, W)) < 0.8).astype(np.float32)
    depth[coverage == 0] = 0.0  # sky: no depth
    noise = (rng.random((H, W), np.float32) * 0.2).astype(np.float32)
    if extreme:
        part = rng.integers(0, 8, (H, W))
        noise[part < 2] = 0.0
        depth[part == 2] = 1e25
        depth[part == 3] = 1e-30
        albedo[part == 4] = 0.5
        albedo[part == 5] = np.nextafter(np.float32(0.5), np.float32(1), dtype=np.float32)
        colors[part == 6] = 1e-30
        colors[part == 7] = 1e-30 * 1.5
    return [torch.from_numpy(a).cuda() for a in (colors, albedo, nrm, depth, coverage)], \
        torch.from_numpy(noise).cuda()


def denoise_fits(design: str, radius: int) -> bool:
    return CD.smem_bytes(design, radius) <= CD.smem_limit(torch.cuda.current_device())


def denoise_compare(got, want) -> dict:
    err = (got - want).abs()
    tol = DENOISE_RTOL * want.abs() + 1e-6 * float(want.abs().max())
    return {"max_abs_err": float(err.max()),
            "bit_equal_share": float((got == want).float().mean()),
            "within_tol": bool((err <= tol).all()) and bool(torch.isfinite(got).all())}


def sass_mix(lib_path) -> dict:
    """What each kernel of a library issues, from ``cuobjdump -sass``: per
    function, the opcodes of its innermost loop that loads (LDS / LDG) and
    holds a MUFU.EX2 (the tap loop) and of the whole function, counted by
    opcode family. An account of what the compiled tap does, not a bound."""
    tool = pathlib.Path(cuda_build.find_nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return {"error": f"{tool} not found"}
    proc = subprocess.run([str(tool), "-sass", str(lib_path)], capture_output=True, text=True)
    if proc.returncode != 0:
        return {"error": proc.stderr[-400:]}
    text = proc.stdout
    out = {}
    for part in re.split(r"\n\s*Function : ", text)[1:]:
        name = part.split()[0]
        insns = [(int(m.group(1), 16), m.group(2)) for m in
                 re.finditer(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", part)]

        def op(text):
            t = text.split()
            t = t[1:] if t and t[0].startswith("@") else t
            return t[0] if t else ""

        loops = []
        for addr, ins in insns:
            bm = re.search(r"BRA\S*\s+0x([0-9a-f]+)", ins)  # cuobjdump: branch to an address
            lo = int(bm.group(1), 16) if bm else None
            if lo is not None and lo < addr:
                body = [op(i) for a, i in insns if lo <= a <= addr]
                if any(o.startswith("MUFU.EX2") for o in body) and \
                        any(o.startswith(("LDS", "LDG")) for o in body):
                    loops.append(body)

        def mix(ops):
            fam = {}
            for o in ops:
                fam[o.split(".")[0]] = fam.get(o.split(".")[0], 0) + 1
            return {"insns": len(ops), "mufu_ex2": sum(o.startswith("MUFU.EX2") for o in ops),
                    "mufu_rcp": sum(o.startswith("MUFU.RCP") for o in ops),
                    "fp32": sum(fam.get(f, 0) for f in ("FADD", "FMUL", "FFMA", "FMNMX")),
                    "lds": fam.get("LDS", 0), "lds_128": sum(o == "LDS.128" for o in ops),
                    "ldg": fam.get("LDG", 0), "calls": fam.get("CALL", 0), "families": fam}

        loop = min(loops, key=len) if loops else []
        out[name] = {"loop": mix(loop), "function": mix([op(i) for _, i in insns])}
    return out


def phase_denoise_check(smi):
    """K8 on the Cornell box's 1080p frame: the 8 spp frame and its noise
    map from render_with_variance (K2 with lum^2) and its AOVs from
    render_aovs (K1), denoised through joint_bilateral_denoise (one K8
    launch, counted, of the design ``design_for`` names); K8 against its
    plain version on the card at radius 2 and 4, with and without the noise
    map, and on the edge cases ``DENOISE_EDGE`` with and without it (rtol
    DENOISE_RTOL, atol 1e-6 max|ref|, finite), by the wrapper's choice and
    by each design where its tile fits (``designs``: each case's bit-equal
    share); the denoised frame nearer a 64 spp frame of disjoint samples
    than the 8 spp frame (tests/test_denoise.py's bar, with and without the
    noise map), for each design; each radius timed (L2 flushed, median of 5,
    beside the plain version), its device time and its bound. Then
    ``design_times``: the designs in turns at radius 0, 2 and 4 on the
    Cornell frame and on seeded random 1080p guides, with device time, bound
    and the share of it; registers, shared memory and spills; the SASS mix
    of each tap loop."""
    cfg, s = cornell_scene(2 * CORNELL_SPP)
    W, H = cfg.image_width, cfg.image_height
    n = W * H
    idx = np.arange(n, dtype=np.int32)
    xs, ys = idx % W, idx // W
    t0 = time.perf_counter()
    noisy, stderr = render_with_variance(cfg, s, xs, ys, MAIN_SPP, device="cuda")
    t1 = time.perf_counter()
    aovs = render_aovs(cfg, s, xs, ys, spp=MAIN_SPP, device="cuda")
    t2 = time.perf_counter()
    ref = render_pixels(cfg, s, xs, ys, spp=CORNELL_SPP, sample_base=CORNELL_SPP,
                        device="cuda").reshape(H, W, 3)
    noisy = noisy.reshape(H, W, 3)
    aovs = {k: v.reshape(H, W, -1).squeeze() for k, v in aovs.items()}
    CD.reset_launches()
    den = joint_bilateral_denoise(noisy, aovs, device="cuda")
    launches, by_design = CD.launches, dict(CD.launches_by_design)
    default = CD.design_for(2)
    require(launches == 1 and by_design[default] == 1, f"denoise: {by_design} K8 launches")
    ranged = joint_bilateral_denoise(noisy, aovs, noise=stderr.reshape(H, W), device="cuda")
    clip = lambda a: np.clip(a, 0, 10)
    mse = lambda a: float(np.mean((clip(a) - clip(ref)) ** 2))
    quality = {"mse_noisy": mse(noisy), "mse_denoised": mse(den), "mse_ranged": mse(ranged)}
    require(quality["mse_denoised"] < quality["mse_noisy"]
            and quality["mse_ranged"] < quality["mse_noisy"], f"denoise quality {quality}")
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).cuda()
    guides = [up(noisy), up(aovs["albedo"]), up(aovs["normal"]), up(aovs["depth"]),
              up(aovs["coverage"])]
    noises = {"noise": up(stderr.reshape(H, W)),
              "no_noise": torch.full((H, W), float("inf"), device="cuda")}
    designs = {d: {"cases": [], "quality": {}} for d in CD.DESIGNS}
    checks, max_err = [], 0.0

    def check(case, args, radius):
        nonlocal max_err
        want = denoise_plain(*args, radius)
        for d in CD.DESIGNS:
            if denoise_fits(d, radius):
                r = {**case, **denoise_compare(
                    CD.denoise_cuda(*args, radius, DEFAULT_SIGMAS, _design=d), want)}
                require(r["within_tol"], f"denoise {d} {r}")
                designs[d]["cases"].append(r)
                if d == CD.design_for(radius):  # the wrapper's choice
                    checks.append({**r, "design": d})
                    max_err = max(max_err, r["max_abs_err"])

    for radius in DENOISE_RADII:
        for tag, nz in noises.items():
            check({"input": "cornell", "radius": radius, "case": tag}, (*guides, nz), radius)
    past = next(r for r in range(1, 4096) if not denoise_fits("tile", r))
    for eh, ew, radius, extreme in (*((*e, False) for e in DENOISE_EDGE),
                                    (*DENOISE_EXTREME, True)):
        radius = past if radius is None else radius
        g, nz = denoise_random_guides(eh, ew, seed=eh * 7919 + ew, extreme=extreme)
        for tag, z in (("noise", nz), ("no_noise", torch.full_like(nz, float("inf")))):
            check({"input": f"{eh}x{ew}" + ("_extreme" if extreme else ""), "radius": radius,
                   "case": tag}, (*g, z), radius)
    require(any(c["design"] == "first" for c in checks), "denoise: no case past the tile")
    for d in CD.DESIGNS:
        den_d = CD.denoise_cuda(*guides, noises["no_noise"], 2, DEFAULT_SIGMAS, _design=d)
        ranged_d = CD.denoise_cuda(*guides, noises["noise"], 2, DEFAULT_SIGMAS, _design=d)
        q = {"mse_denoised": mse(den_d.cpu().numpy()), "mse_ranged": mse(ranged_d.cpu().numpy())}
        q["passes"] = q["mse_denoised"] < quality["mse_noisy"] and \
            q["mse_ranged"] < quality["mse_noisy"]
        require(q["passes"], f"denoise {d} quality {q}")
        designs[d]["quality"] = q
    timing = {}
    for radius in DENOISE_RADII:
        nz = noises["noise"]
        t = time_launches({"k8": lambda: CD.denoise_cuda(*guides, nz, radius, DEFAULT_SIGMAS),
                           "plain": lambda: denoise_plain(*guides, nz, radius)})
        timing[radius] = {"ms": t["k8"][0], "ms_all": t["k8"][1], "plain_ms": t["plain"][0],
                          "design": CD.design_for(radius),
                          **launch_device_ms(
                              lambda: CD.denoise_cuda(*guides, nz, radius, DEFAULT_SIGMAS),
                              "denoise"),
                          **denoise_bound(n, radius)}
        timing[radius]["roofline_share"] = timing[radius]["bound_ms"] / timing[radius]["ms"]
    # the designs in turns, on the Cornell frame and on seeded random guides
    rnd, rnd_noise = denoise_random_guides(H, W, seed=1)
    inputs = {"cornell": (*guides, noises["noise"]), "random": (*rnd, rnd_noise)}
    design_times = []
    for radius in (0, *DENOISE_RADII):
        for name, args in inputs.items():
            if radius == 0 and name == "random":
                continue
            fns = {d: (lambda d=d: CD.denoise_cuda(*args, radius, DEFAULT_SIGMAS, _design=d))
                   for d in CD.DESIGNS if denoise_fits(d, radius)}
            t = time_launches(fns)
            b = denoise_bound(n, radius)
            for d, fn in fns.items():
                dev = launch_device_ms(fn, "denoise")
                design_times.append({
                    "design": d, "input": name, "radius": radius, "ms": t[d][0],
                    "ms_all": t[d][1], "device_ms": dev["device_ms"],
                    "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
                    "roofline_share": b["bound_ms"] / t[d][0],
                    "device_roofline_share": b["bound_ms"] / dev["device_ms"]})
    resources = {r["entry"]: r for r in CD.LIBRARY.resources()}
    sass = sass_mix(CD.LIBRARY.path())
    for d in CD.DESIGNS:
        ent = [k for k in resources if f"denoise_{d}" in k]
        require(len(ent) == 1, f"denoise {d}: entries {list(resources)}")
        designs[d]["resources"] = {k: resources[ent[0]][k] for k in
                                   ("registers", "spill_store_bytes", "spill_load_bytes",
                                    "smem_bytes")}
        designs[d]["smem_bytes_r2_r4"] = [CD.smem_bytes(d, r) for r in DENOISE_RADII]
        mix = [v for k, v in sass.items() if f"denoise_{d}" in k] if "error" not in sass else []
        designs[d]["sass"] = mix[0] if mix else sass
    res = {"launches": launches, "launches_by_design": by_design, "default_design": default,
           "past_tile_radius": past, "checks": checks, "max_abs_err": max_err,
           "timing": timing, "quality": quality, "designs": designs,
           "design_times": design_times, "variance_pass_s": t1 - t0, "aov_pass_s": t2 - t1,
           "registers": [(k["registers"], k["spill_store_bytes"] + k["spill_load_bytes"])
                         for k in CD.LIBRARY.resources()], "card": smi}
    emit("denoise_check", **{k: v for k, v in res.items()
                             if k not in ("checks", "designs", "design_times")},
         checks_within_tol=all(c["within_tol"] for c in checks), n_checks=len(checks))
    emit("denoise_checks", checks=checks)
    emit("denoise_designs", designs=designs, card=smi)
    emit("denoise_design_times", design_times=design_times, card=smi)
    return res


def large_walk(large, kernel, frame) -> dict:
    """A ray-query kernel's readings on the large scene for the kernels
    line: its launches in the scan frame, the 65,536-ray batches and the
    render tile's batches."""
    keys = ("rays", "ms", "device_ms", "plain_ms", "max_abs_err", "bound_ms", "bound_by")
    return {"launches": large["frames"][frame]["launches"],
            **{sh["shape"].split()[-1]: {k: sh[k] for k in keys} for sh in large[kernel]},
            "tile_ms": {k: v for k, v in large["tile_ms"].items() if k.startswith(kernel)}}


def large_path(large, launch, frame) -> dict:
    """A path kernel's readings on the large scene for the kernels line: its
    launches in the frame and the 8 spp launch's time, device time and
    bound."""
    t = large["timing"][launch]
    return {"launches": large["frames"][frame]["launches"],
            "frame_seconds": large["frames"][frame]["seconds"],
            **{k: t[k] for k in ("ms", "device_ms", "bound_ms", "bound_by", "table_bytes")},
            "launch_vs_scan_frame": t["vs_scan_frame"]}


def grad_kernel_entry(r) -> dict:
    """A gather transpose's numbers for the kernels line: its time, plain,
    bound and library times, and its split."""
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape", "host_ms",
            "device_ms", "device_ms_by_kernel")
    return {k: r[k] for k in keys}


def design_summary(kernel, designs, split) -> dict:
    """A path kernel's designs for the kernels line: per table kind and
    pixel order the design the wrapper takes and both designs' times in this
    call; the phase split of its main path."""
    out = {}
    for name, kind, order in DESIGN_CASES:
        if name == kernel:
            res = designs[f"{kernel}_{kind}_{order}"]
            width = 0 if kind == "binary" else LAYOUTS[kind].w_row
            out[f"{kind}_{order}"] = {"design": CM.DESIGN_BY_WIDTH[width],
                                      **{f"{d}_ms": res[d]["ms"] for d in CM.DESIGNS}}
    return {"designs": out, "phase_split": {k: v for k, v in split.items()
                                            if k.startswith(kernel + "_")}}


def anim_kernel(anim, tag, kernel) -> dict:
    """A kernel's launches and frames on one CLI run of the animated frame
    loop (phase_animation_cli), for the kernels line."""
    run = anim["cli"][tag]
    return {"run": tag, "launches_per_frame": [x["launches"][kernel] for x in run["frames"]],
            "render_ms": [x["render_ms"] for x in run["frames"]],
            "setup_ms": [x["setup_ms"] for x in run["frames"]],
            "pack_ms": [x["pack_ms"] for x in run["frames"]],
            "msamples_per_s": [x["msamples_per_s"] for x in run["frames"]],
            "peak_memory_allocated_bytes": [x["peak_memory_allocated_bytes"]
                                            for x in run["frames"]]}


# ---------------------------------------------------------------- S10: sharding

SHARD_MESHES = ((4, 1), (2, 2), (1, 4))  # (tiles, samples) of the golden frame's meshes
SHARD_LIST = (640, 360)  # the scan shards' pixel list: the frame's first 640 x 360 pixels
SHARD_SCAN_SPP = 2
SHARD_GRAD_MESH = (4, 1)  # 1 spp: a samples axis needs an even spp
SHARD_GRAD_LANES = 4096
HOT_ROWS = 1024  # DevicePacker(hot_rows=): the JAX CLI's hot table
GRAD_RTOL = 2e-4  # tests/test_parallel.py's gradient bar; atol 1e-6 max|ref| on the card
MULTIHOST_DIR = ROOT / "build" / "multihost"  # the demo's frames (git-ignored)
MULTIHOST_ARGS = ("--processes", "2", "--frames", "4", "--size", "320x180", "--spp", "2")


def shard_devices(n=4) -> list:
    """n mesh slots over this machine's cards: distinct cards while there
    are enough of them, else the cards in turn (one card: n times)."""
    cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [cards[i % len(cards)] for i in range(n)]


def shard_order_sum(parts):
    """Tuples of sums added in shard order (the sharded renderers' order)."""
    total = list(parts[0])
    for part in parts[1:]:
        total = [a + b for a, b in zip(total, part)]
    return tuple(total)


def bit_equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def phase_shard_check(cfg, binary, wide, smi):
    """S10's pixel / sample sharding on the golden frame at the main path's
    width (1920x1080 x 5 bounces x MAIN_SPP): make_sharded_render_megakernel
    (K2, one launch a shard) and make_sharded_render(wavefront=True) (K5 on
    the binary tables, one launch a shard) on the meshes (4, 1), (2, 2) and
    (1, 4): each run's launches tiles x samples; tiles only bit-equal to one
    single-device launch; with a samples axis bit-equal to the shard-order
    sum of single-device launches over the same sample ranges, and within
    the JAX bar of one launch. The scan shards (P1 on the binary tables, K1
    on w8) on a 640x360 list of the frame at (2, 2), bit-equal to the
    shard-order sum of single-device scans. render_frame_sharded through K5
    on this machine's mesh (local_device_mesh) against render_frame's K5
    frame. Meshes take distinct cards where there are enough."""
    W, H = cfg.image_width, cfg.image_height
    n = W * H
    devs = shard_devices(4)
    counters = (CT, CW, CM, CWF)
    xs, ys = frame_list(cfg)
    one = {"megakernel": tuple(CM.megakernel_cuda(cfg, wide, n, MAIN_SPP)[:3]),
           "wavefront": tuple(CWF.wavefront_cuda(cfg, binary, xs, ys, MAIN_SPP)[:3])}
    out = {"cards": torch.cuda.device_count(), "mesh_devices": [str(d) for d in devs]}
    for kernel, mod in (("megakernel", CM), ("wavefront", CWF)):
        for t, s in SHARD_MESHES:
            mesh = make_mesh(t, s, devs)
            if kernel == "megakernel":
                fn = lambda: make_sharded_render_megakernel(cfg, mesh, n, MAIN_SPP)(wide)
            else:
                fn = lambda: make_sharded_render(cfg, mesh, MAIN_SPP, wavefront=True)(
                    binary, xs, ys)
            got, sec, peak, _ = frame_launches(f"shard {kernel} {t}x{s}", counters,
                                               {mod: t * s}, fn)
            local = MAIN_SPP // s
            if kernel == "megakernel":
                parts = [CM.megakernel_cuda(cfg, wide, n, local, sample_base=k * local)[:3]
                         for k in range(s)]
            else:
                parts = [CWF.wavefront_cuda(cfg, binary, xs, ys, local,
                                            sample_base=k * local)[:3] for k in range(s)]
            require(bit_equal(got, shard_order_sum(parts)),
                    f"shard {kernel} {t}x{s}: not the shard-order sum of its ranges")
            if s == 1:
                require(bit_equal(got, one[kernel]), f"shard {kernel} {t}x{s}: not one launch")
            cmp = mk_compare(f"shard {kernel} {t}x{s} vs one launch", got, one[kernel],
                             MAIN_SPP, 0, 0, W)
            out[f"{kernel}_{t}x{s}"] = {
                "launches": t * s, "seconds": sec, "peak_memory_allocated_bytes": int(peak),
                "bit_equal_to_shard_order_sum": True,
                "vs_one_launch": {k: cmp[k] for k in ("close_share", "bit_equal_share",
                                                      "max_abs_err")}}
    # the scan shards on a 640x360 list, P1 (binary) and K1 (w8)
    m = SHARD_LIST[0] * SHARD_LIST[1]
    lx, ly = xs[:m], ys[:m]
    for name, scene, mod in (("scan_binary", binary, CT), ("scan_w8", wide, CW)):
        mesh = make_mesh(2, 2, devs)
        got, sec, _, _ = frame_launches(
            f"shard {name}", counters,
            {mod: 4 * (SHARD_SCAN_SPP // 2) * (1 + cfg.max_bounces)},
            lambda: make_sharded_render(cfg, mesh, SHARD_SCAN_SPP)(scene, lx, ly))
        half = SHARD_SCAN_SPP // 2
        parts = [tuple(torch.from_numpy(np.ascontiguousarray(c)).cuda() for c in render_pixels(
            cfg, scene, lx, ly, spp=half, sample_base=k * half, average=False,
            megakernel=False).T) for k in range(2)]
        require(bit_equal(got, shard_order_sum(parts)),
                f"shard {name}: not the shard-order sum of the single-device scans")
        out[name] = {"mesh": [2, 2], "pixels": m, "spp": SHARD_SCAN_SPP, "seconds": sec,
                     "launches": 4 * half * (1 + cfg.max_bounces),
                     "bit_equal_to_shard_order_sum": True}
    # render_frame_sharded through K5 on this machine's mesh
    mesh = local_device_mesh()
    tiles = mesh.shape["tiles"]
    colors, sec, peak, _ = frame_launches(
        "render_frame_sharded", counters, {CWF: tiles},
        lambda: render_frame_sharded(cfg, binary, mesh, MAIN_SPP, wavefront=True))
    ref, _ = render_frame(cfg, binary, spp=MAIN_SPP, wavefront=True)
    equal = float((colors == ref).all(-1).mean())
    require(colors.shape == (H, W, 3) and np.isfinite(colors).all(), "render_frame_sharded")
    if tiles == 1:
        require(equal == 1.0, f"render_frame_sharded on one card: {equal} of pixels equal")
    out["render_frame_sharded"] = {"mesh": mesh.shape, "launches": tiles, "seconds": sec,
                                   "peak_memory_allocated_bytes": int(peak),
                                   "pixels_bit_equal_to_render_frame": equal}
    emit("shard_check", width=W, height=H, bounces=cfg.max_bounces, spp=MAIN_SPP, **out,
         card=smi)
    return out


def grads_close(tag, got, ref) -> float:
    """Every field of ``got`` within GRAD_RTOL of ``ref`` (atol 1e-6
    max|ref|), finite; returns the worst error over that bar."""
    worst = 0.0
    for k, r in ref.items():
        g, r = got[k].double().cpu(), r.double().cpu()
        require(bool(torch.isfinite(g).all()), f"{tag} {k}: not finite")
        bar = GRAD_RTOL * r.abs() + 1e-6 * float(r.abs().max()) + 1e-30
        e = float(((g - r).abs() / bar).max())
        require(e <= 1.0, f"{tag} {k}: {e} x the bar")
        worst = max(worst, e)
    return worst


def phase_shard_grad_check(cfg, wide, binary, ref, smi):
    """S10's sharded gradients. make_sharded_fast_grad_frame at the main
    gradient's shape (1920x1080 x 5 bounces x GRAD_SPP, w8) on a
    SHARD_GRAD_MESH mesh: one K6 record launch a shard, the replays'
    backward on K7a / K7b; the loss within rtol 1e-5 and every field within
    GRAD_RTOL of main_path_grad's single-device all-fields step (``ref``).
    make_sharded_render_grad on 4,096 lanes of the golden 640x360 frame
    (binary, TESTING's 4 bounces) on a (1, 2) mesh at 2 spp, remat on: P1
    twice a bounce (the forward and its recomputation), against
    render_value_and_grad of each sample, averaged."""
    counters = (CT, CW, CM, CWF, CG)
    n = cfg.image_width * cfg.image_height
    t, s = SHARD_GRAD_MESH
    mesh = make_mesh(t, s, shard_devices(t * s))
    ref_loss, ref_grads = ref
    for mod in counters:
        mod.reset_launches()
    t0 = time.perf_counter()
    loss, grads = make_sharded_fast_grad_frame(cfg, mesh, n, GRAD_SPP)(wide)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    chunks = -(-(n * GRAD_SPP // (t * s)) // diff_render.REPLAY_CHUNK)  # a shard's
    launches = {"k6": CM.record_launches, "k7a": CG.small_table_launches,
                "k7b": CG.row_launches, "p1": CT.launches, "k1": CW.launches,
                "k2": CM.launches, "k5": CWF.launches}
    want = {"k6": t * s, "k7a": 2 * chunks * t * s,
            "k7b": 3 * (1 + cfg.max_bounces) * chunks * t * s,
            "p1": 0, "k1": 0, "k2": 0, "k5": 0}
    require(launches == want, f"sharded fast gradient launches {launches}, expected {want}")
    rel = abs(float(loss) - float(ref_loss)) / abs(float(ref_loss))
    require(rel <= 1e-5, f"sharded fast gradient loss {float(loss)} vs {float(ref_loss)}")
    fast = {"mesh": [t, s], "spp": GRAD_SPP, "seconds": sec, "launches": launches,
            "loss": float(loss), "loss_single_device": float(ref_loss), "loss_rel_err": rel,
            "worst_err_over_bar": grads_close("sharded fast gradient", grads, ref_grads)}
    del grads

    tcfg = TESTING
    lanes = SHARD_GRAD_LANES
    pix = torch.arange(lanes, dtype=torch.int32, device="cuda") + 200 * tcfg.image_width
    xs, ys = pix % tcfg.image_width, pix // tcfg.image_width
    mesh = make_mesh(1, 2, shard_devices(2))
    for mod in counters:
        mod.reset_launches()
    t0 = time.perf_counter()
    loss, grads = make_sharded_render_grad(tcfg, mesh, 2)(binary, xs, ys)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches = {"p1": CT.launches, "k7a": CG.small_table_launches, "k7b": CG.row_launches}
    want_p1 = 2 * (1 + tcfg.max_bounces) * 2  # 2 shards x 1 sample, forward + remat
    require(launches["p1"] == want_p1 and launches["k7a"] > 0 and launches["k7b"] > 0,
            f"sharded slow gradient launches {launches}, P1 expected {want_p1}")
    ref_loss, ref_grads = 0.0, None
    for k in range(2):
        si = torch.full((lanes,), k, dtype=torch.int32, device="cuda")
        l, g = render_value_and_grad(tcfg, binary, xs, ys, si)
        ref_loss += float(l) / 2
        g = {f: v / 2 for f, v in g.items()}
        ref_grads = g if ref_grads is None else {f: ref_grads[f] + g[f] for f in g}
    rel = abs(float(loss) - ref_loss) / abs(ref_loss)
    require(rel <= 1e-5, f"sharded slow gradient loss {float(loss)} vs {ref_loss}")
    slow = {"mesh": [1, 2], "lanes": lanes, "spp": 2, "bounces": tcfg.max_bounces,
            "seconds": sec, "launches": launches, "loss_rel_err": rel,
            "worst_err_over_bar": grads_close("sharded slow gradient", grads, ref_grads)}
    emit("shard_grad_check", fast_frame=fast, slow_lanes=slow,
         bar=f"loss rtol 1e-5; fields rtol {GRAD_RTOL}, atol 1e-6 max|ref|", card=smi)
    return {"fast": fast, "slow": slow}


def phase_geomshard_check(cfg, host, binary, smi):
    """S10's geometry sharding on the large scene (the host Scene and the
    replicated binary tables of large_scene's build): split over 2 and 4
    shards (build_shard_scenes on the card; at 4 the greedy assignment
    leaves a shard without instances, every subframe's TLAS there has no
    node), per-shard table bytes against the replicated scene's; the
    1920x1080 x 1 spp scan, geometry-sharded (P1 per shard per bounce), on
    2 shards, 4 shards and a (geom 2, tiles 2) mesh: launches, seconds, the
    JAX bar against the single-device scan frame and the bit-equal share;
    the (2, 2) mesh bit-equal to 2 shards."""
    W, H = cfg.image_width, cfg.image_height
    n = W * H
    xs, ys = frame_pixels(cfg)
    counters = (CT, CW, CM, CWF)
    scan, scan_s, _, _ = frame_launches(
        "geomshard single-device scan", counters,
        {CT: -(-n // tile_pixels(binary)) * (1 + cfg.max_bounces)},
        lambda: render_pixels(cfg, binary, xs, ys, spp=1, average=False, megakernel=False))
    scan = tuple(torch.from_numpy(np.ascontiguousarray(scan[:, k])) for k in range(3))
    replicated = sum(field_bytes(binary, BINARY_TABLES).values())
    out = {"replicated_table_bytes": replicated, "scan_seconds": scan_s}
    devs = shard_devices(4)
    results = {}
    for shards, tiles in ((2, None), (4, None), (2, 2)):
        t0 = time.perf_counter()
        scenes, assign = build_shard_scenes(host, cfg, shards, device=devs[:shards])
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        grid = np.array(devs[: shards * (tiles or 1)], dtype=object)
        mesh = (Mesh(grid.reshape(shards, tiles), ("geom", "tiles")) if tiles
                else Mesh(grid, ("geom",)))
        tag = f"geom {shards}" + (f" x tiles {tiles}" if tiles else "")
        fn = make_geom_sharded_render(cfg, mesh, 1, tile_axis="tiles" if tiles else None)
        got, sec, peak, _ = frame_launches(tag, counters,
                                           {CT: shards * (tiles or 1) * (1 + cfg.max_bounces)},
                                           lambda: fn(scenes, xs, ys))
        got = tuple(g.cpu() for g in got)
        cmp = mk_compare(f"{tag} vs the scan frame", got, scan, 1, 0, 0, W)
        empty = [s for s in range(shards) if not (assign == s).any()]
        res = {"shards": shards, "tiles": tiles or 1, "seconds": sec,
               "launches": shards * (tiles or 1) * (1 + cfg.max_bounces),
               "peak_memory_allocated_bytes": int(peak), "build_seconds": build_s,
               "instances_per_shard": [int((assign == s).sum()) for s in range(shards)],
               "shard_table_bytes": [sum(field_bytes(sc, BINARY_TABLES).values())
                                     for sc in scenes],
               "empty_shards": empty,
               "vs_scan_frame": {k: cmp[k] for k in ("finite_share", "close_share", "bar",
                                                     "bit_equal_share", "max_abs_err")}}
        res["shard_over_replicated"] = [b / replicated for b in res["shard_table_bytes"]]
        for s in empty:
            require(scenes[s].nl8.shape[0] == 0 and int(scenes[s].sf_tlas_count.max()) == 0,
                    f"{tag}: empty shard {s} has node rows")
        if shards == 4:
            require(empty, f"{tag}: no shard without instances ({res['instances_per_shard']})")
        results[tag] = (res, got)
        out[tag] = res
        del scenes
    require(bit_equal(results["geom 2 x tiles 2"][1], results["geom 2"][1]),
            "geom 2 x tiles 2: not the geom 2 sums")
    emit("geomshard_check", width=W, height=H, bounces=cfg.max_bounces, spp=1, **out,
         card=smi)
    return out


def hotperm_check(cfg, s, s_cpu, packer, smi):
    """S10's hot-row permutation on the animated frame (stand-ins, frame
    1000 at ANIM_CHECK_SPP): DevicePacker(hot_rows=HOT_ROWS) on the card,
    its tables equal to the CPU's hot pack byte for byte, its hot table the
    prefix of its mega-table; K1 on the permuted tables (65,536 rays, the
    primary and first bounce batch, closest and any-hit lanes) and one K2
    launch of 2 spp over the frame bit-equal to the unpermuted pack's; the
    two packs' K2 launches timed in turns (a reading only)."""
    W, H = cfg.image_width, cfg.image_height
    n = W * H
    frame = ANIM_CHECK_FRAMES[0]
    setup_animation_frame(s, frame, cfg)
    setup_animation_frame(s_cpu, frame, cfg)
    base = packer.pack_frame(s)
    t0 = time.perf_counter()
    hot_packer = DevicePacker(s, wide=True, chunk_max=CHUNK_MAX, hot_rows=HOT_ROWS)
    hot = hot_packer.pack_frame(s)
    torch.cuda.synchronize()
    packer_s = time.perf_counter() - t0
    packs_equal("hotperm", hot, DevicePacker(s_cpu, wide=True, chunk_max=CHUNK_MAX,
                                             hot_rows=HOT_ROWS, device="cpu").pack_frame(s_cpu))
    require(hot.hot_rows.shape[0] == HOT_ROWS
            and torch.equal(hot.hot_rows.view(torch.int32),
                            hot.wide_rows[:HOT_ROWS].view(torch.int32)),
            "hotperm: the hot table is not the mega-table's prefix")
    idx = torch.arange(LARGE_BATCH, dtype=torch.int64, device="cuda") * n // LARGE_BATCH
    q = capture_queries(cfg, base, (idx % W).to(torch.int32), (idx // W).to(torch.int32))
    CW.reset_launches()
    for (a, k), name in zip(q[:2], ("primary", "bounce")):
        ha, oa = ray_query(*a, **k)
        hb, ob = ray_query(hot, *a[1:], **k)
        require(all(torch.equal(x, y) for x, y in zip(ha, hb)) and torch.equal(oa, ob),
                f"hotperm: K1 {name} batch differs on the permuted tables")
    k1_launches = CW.launches
    require(k1_launches == 4, f"hotperm: {k1_launches} K1 launches")
    CM.reset_launches()
    a, b = CM.megakernel_cuda(cfg, base, n, 2), CM.megakernel_cuda(cfg, hot, n, 2)
    require(bit_equal(a[:3], b[:3]) and int(b[4]) == 0,
            "hotperm: the K2 launch's sums differ on the permuted tables")
    k2_launches = CM.launches
    t = time_launches({"unpermuted": lambda: CM.megakernel_cuda(cfg, base, n, 2),
                       "hot": lambda: CM.megakernel_cuda(cfg, hot, n, 2)}, reps=3)
    out = {"frame": frame, "hot_rows": HOT_ROWS, "hot_packer_s": packer_s,
           "wide_rows": list(hot.wide_rows.shape), "card_pack_equals_cpu": True,
           "k1_launches": k1_launches, "k1_bit_equal": True,
           "k2_launches": k2_launches, "k2_spp": 2, "k2_bit_equal": True,
           "k2_ms": {k: v[0] for k, v in t.items()},
           "k2_ms_all": {k: v[1] for k, v in t.items()}}
    emit("hotperm_check", **out, card=smi)
    del hot_packer, hot, base, q
    return out


# the chunked packer's options checked on the animated frame: the CLI's pack
# ("base"), smaller chunks, one octant's trees, and the static instances
# baked into world space
PACK_OPTIONS = {"base": {"chunk_max": CHUNK_MAX}, "256": {"chunk_max": 256},
                "o1": {"chunk_max": CHUNK_MAX, "octants": 1},
                "bake": {"chunk_max": CHUNK_MAX, "bake_static": True}}
PACK_K2_SPP = 2  # one K2 / K5 dispatch of the animated frame (over LARGE_SCENE_NODES)


def pack_k1(tag, scene, base_hits, batch) -> dict:
    """K1 on one 65,536-ray batch of the animated frame on a pack: ids equal
    to the plain wide walk on the same pack (1e-6), its rows a ray from the
    plain walk's counts; against the base pack's K1 hits, the share of equal
    ids and, on the lanes that differ, the thit of both packs (a reading)."""
    a, k = batch
    args = (scene, *a[1:])
    hk, ok = CW.wide_ray_query_cuda(*args, **k)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hp, op, counts = wide_ray_query_plain(*args, **k, return_counts=True)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = compare_hits(tag, hk, ok, hp, op)
    active = a[7]
    hb = base_hits
    same = (hk.inst == hb.inst) & (hk.prim == hb.prim)
    differ = (~same & active).nonzero()[:, 0][:8]
    rows = counts.wide_rows + counts.leaf_rows + counts.inst_rows
    return {"max_abs_err": err, "plain_ms": plain_ms, "rows": rows,
            "rows_a_ray": rows / max(int(active.sum()), 1),
            "ids_equal_base_share": float(same[active].float().mean()),
            "thit_equal_base_share": float((bits(hk.thit) == bits(hb.thit))[active]
                                           .float().mean()),
            "differing_lanes": [{"lane": int(i), "thit": float(hk.thit[i]),
                                 "thit_base": float(hb.thit[i])} for i in differ]}


def packer_options_check(cfg, s, s_cpu, packer, base_k1, smi):
    """The chunked packer's options on the animated frame (stand-ins, frame
    1000, 1920x1080 x 5 bounces at ANIM_CHECK_SPP; packs of PACK_OPTIONS,
    ``packer`` the base): each pack on the card equal to the CPU's
    (packed in a thread of their own beside the launches), its rows, bytes
    and packer seconds; K1 on the frame's 65,536-ray primary and bounce
    batches (closest and any-hit lanes) equal to the plain wide walk on the
    same pack, and against the base pack's K1 the share of equal ids; one
    K2 launch of PACK_K2_SPP within the JAX bar of the base pack's (and its
    bit-equal share); one K5 (w8) launch equal to K2 on the same pack, bit
    for bit; K2 timed on the four packs in turns (3 repeats, device time
    beside), next to each pack's rows a ray (a reading: no gain claimed).
    Then setup_animation_frame(build_tlas_trees=False) at the production
    preset's 1024 spp (128 subframes) against True: host seconds of each,
    the frame's wide_rows and every subframe's root cursors byte-equal, one
    K2 launch bit-equal. The launches of each kernel on the new packs are
    counted from 0 over this phase's drive (K1's batches, K2's and K5's
    launches). ``base_k1``: animation_frames' K1 readings of the base pack
    on the same batches (measure_wide_shape)."""
    W, H = cfg.image_width, cfg.image_height
    n = W * H
    frame = ANIM_CHECK_FRAMES[0]
    setup_animation_frame(s, frame, cfg)
    setup_animation_frame(s_cpu, frame, cfg)

    def cpu_packs():
        return {k: DevicePacker(s_cpu, wide=True, device="cpu", **kw).pack_frame(s_cpu)
                for k, kw in PACK_OPTIONS.items() if k != "base"}

    packs = {"base": packer.pack_frame(s)}
    out = {k: {} for k in PACK_OPTIONS}
    with ThreadPoolExecutor(1) as pool:
        cpu = pool.submit(cpu_packs)
        for k, kw in PACK_OPTIONS.items():
            if k != "base":
                t0 = time.perf_counter()
                packs[k] = DevicePacker(s, wide=True, **kw).pack_frame(s)
                torch.cuda.synchronize()
                out[k]["packer_s"] = time.perf_counter() - t0
            out[k].update(wide_rows=int(packs[k].wide_rows.shape[0]),
                          wide_bytes=packs[k].wide_rows.numel() * 4,
                          wide_over_l2=packs[k].wide_rows.numel() * 4 / L2_BYTES)
        idx = torch.arange(LARGE_BATCH, dtype=torch.int64, device="cuda") * n // LARGE_BATCH
        q = capture_queries(cfg, packs["base"], (idx % W).to(torch.int32),
                            (idx // W).to(torch.int32))[:2]
        for c in (CW, CM, CWF):
            c.reset_launches()
        xs_t, ys_t = (torch.from_numpy(v).cuda() for v in frame_pixels(cfg))
        sums, base_hits = {}, {}
        for k, pack in packs.items():
            for (a, kw), name in zip(q, ("primary", "bounce")):
                if k == "base":
                    base_hits[name] = CW.wide_ray_query_cuda(*a, **kw)[0]
                else:
                    out[k][f"k1_{name}"] = pack_k1(f"{k} K1 {name}", pack, base_hits[name],
                                                   (a, kw))
            k2 = CM.megakernel_cuda(cfg, pack, n, PACK_K2_SPP)
            k5 = CWF.wavefront_cuda(cfg, pack, xs_t, ys_t, PACK_K2_SPP)
            require(bit_equal(k2[:3], k5[:3]) and int(k2[4]) == 0 and int(k5[4]) == 0,
                    f"pack {k}: K5 (w8) differs from K2, or a sample was abandoned")
            sums[k] = k2[:3]
            if k != "base":
                cmp = mk_compare(f"pack {k}: K2 vs the base pack's", sums[k], sums["base"],
                                 PACK_K2_SPP, 0, 0, W)
                out[k]["k2_vs_base"] = {key: cmp[key] for key in (
                    "finite_share", "close_share", "bar", "bit_equal_share", "max_abs_err")}
            out[k]["k5_equals_k2"] = True
        launches = {"k1": CW.launches, "k2": CM.launches, "k5": CWF.launches}
        require(launches == {"k1": 2 * len(packs), "k2": len(packs), "k5": len(packs)},
                f"packer options: launches {launches}")
        t = time_launches({k: functools.partial(CM.megakernel_cuda, cfg, p, n, PACK_K2_SPP)
                           for k, p in packs.items()}, reps=3)
        for k, p in packs.items():
            out[k].update(k2_ms=t[k][0], k2_ms_all=t[k][1],
                          **launch_device_ms(functools.partial(CM.megakernel_cuda, cfg, p, n,
                                                               PACK_K2_SPP),
                                             "megakernel", reps=3))
        del q
        for k, dev_cpu in cpu.result().items():
            packs_equal(f"pack {k}", packs[k], dev_cpu)
            out[k]["card_pack_equals_cpu"] = True
    # the base pack's rows a ray: the plain walk's counts of the same
    # batches in animation_frames (where K1 is held to it on this pack)
    for sh in base_k1:
        rows = sh["wide_rows"] + sh["leaf_rows"] + sh["inst_rows"]
        out["base"][f"k1_{sh['shape'].split()[-1]}"] = {"rows": rows,
                                                        "rows_a_ray": rows / sh["active"]}
    del packs, sums

    # the frame's setup without the per-subframe binary TLAS builds
    cfg_sub = dataclasses.replace(PRODUCTION)
    skip = {}
    for build in (True, False):
        t0 = time.perf_counter()
        setup_animation_frame(s, frame, cfg_sub, build_tlas_trees=build)
        setup_s = time.perf_counter() - t0
        dev = packer.pack_frame(s)
        torch.cuda.synchronize()
        base = int(dev.wide_root_base)
        skip[build] = {"setup_s": setup_s, "pack_s": time.perf_counter() - t0 - setup_s,
                       "subframes": len(s.subframes),
                       "tlas_nodes": sum(sf.tlas.node_count for sf in s.subframes),
                       "rows": dev.wide_rows,
                       "roots": torch.stack([dev.wide_root[sf.tlas.node_offset - base]
                                             for sf in s.subframes]),
                       "k2": CM.megakernel_cuda(cfg_sub, dev, n, PACK_K2_SPP)[:3]}
        del dev
    a, b = skip[True], skip[False]
    require(b["tlas_nodes"] == 0 and a["subframes"] == b["subframes"]
            == cfg_sub.subframe_count, "build_tlas_trees=False: subframe handles")
    require(torch.equal(bits(a["rows"]), bits(b["rows"])) and torch.equal(a["roots"], b["roots"]),
            "build_tlas_trees=False: the wide tables or root cursors differ")
    require(bit_equal(a["k2"], b["k2"]), "build_tlas_trees=False: the K2 launch differs")
    skip_out = {str(build).lower(): {k: v[k] for k in ("setup_s", "pack_s", "subframes",
                                                          "tlas_nodes")}
                for build, v in skip.items()}
    del skip, a, b
    setup_animation_frame(s, frame, cfg)
    emit("packer_options_check", frame=frame, spp=PACK_K2_SPP, options=PACK_OPTIONS,
         packs=out, launches=launches, build_tlas_trees=skip_out,
         tables_equal_without_tlas_trees=True, k2_bit_equal_without_tlas_trees=True,
         card=smi)
    return {"packs": out, "launches": launches, "build_tlas_trees": skip_out}


def start_multihost_demo() -> dict:
    """Start parallel.multihost_demo (2 processes, see phase_multihost_check)
    in a session of its own, its output to a file; it needs only P1's
    library, so it runs while the other libraries build."""
    shutil.rmtree(MULTIHOST_DIR, ignore_errors=True)
    MULTIHOST_DIR.mkdir(parents=True)
    log = MULTIHOST_DIR / "demo.log"
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "pathtracing_tpu_torch.parallel.multihost_demo",
             "--device", "cuda", *MULTIHOST_ARGS, "--out", str(MULTIHOST_DIR / "frames"),
             "--timeout", str(CLI_TIMEOUT)],
            cwd=ROOT, stdout=f, stderr=subprocess.STDOUT, start_new_session=True)
    return {"proc": proc, "log": log, "t0": time.perf_counter()}


def phase_multihost_check(demo, smi):
    """S10's frames over hosts: parallel.multihost_demo (``demo``, started
    while the kernels built) with 2 processes on this machine, each joining
    one gloo group, summing one per process with an all_reduce, and
    rendering its round-robin frames of the golden scene on the card
    (render_frames_distributed: render_frame_sharded's scan on
    local_device_mesh, P1); the frames byte-identical to the demo process's
    own render of them."""
    proc = demo["proc"]
    try:
        rc = proc.wait(timeout=CLI_TIMEOUT + 60)
    finally:
        stop_process_group(proc)
    sec = time.perf_counter() - demo["t0"]
    text = demo["log"].read_text()
    require(rc == 0, f"multihost demo: exit {rc}\n{text[-3000:]}")
    lines = [json.loads(x) for x in text.splitlines() if x.startswith("{")]
    result = lines[-1]
    hosts = [x for x in lines if "host" in x]
    require(result["ok"] and not result["differ_from_single"] and len(hosts) == 3,
            f"multihost demo: {result}")
    require(all(x["launches"]["ray_query"] > 0 for x in hosts),
            f"multihost demo: P1 launches {[x['launches'] for x in hosts]}")
    emit("multihost_check", seconds_since_start=sec, ran_while_kernels_built=True,
         result=result, hosts=hosts, card=smi)
    return {"seconds_since_start": sec, "hosts": hosts, "result": result}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    emit("device", nvidia_smi=smi, kind=kind, torch=torch.__version__,
         cuda=torch.version.cuda, numpy=np.__version__,
         python=sys.version.split()[0])

    # the phases that need only P1's, K1's and P2's libraries run while the
    # path kernels' libraries build
    demo, early = {}, {}
    try:
        built = phase_build((("ray_query", "ray_query_nl5", "wide_ray_query", "gather_rows"),
                             lambda: early.update(early_phases(smi))))
        return run_phases(t_start, smi, kind, built, early, demo)
    finally:
        if demo:
            stop_process_group(demo["proc"])


def early_phases(smi) -> dict:
    """The scenes, and the phases of P1, K1 and P2 alone (kernel_check,
    wide_kernel_check, breakdown, gather_probe): their results by name."""
    scene_g = load_golden(str(GOLDEN / "scene.gold"))
    rays_g = load_golden(str(GOLDEN / "rays.gold"))
    scene = scene_device_from_golden(scene_g, TESTING)
    # PRODUCTION geometry with spp cut to MAIN_SPP; the scene is built with
    # the config it is rendered with (one subframe row per motion-blur step)
    prod_cfg = dataclasses.replace(PRODUCTION, samples_per_pixel=MAIN_SPP)
    prod_scene = scene_device_from_golden(scene_g, prod_cfg)
    prod_wide = scene_device_from_golden(
        scene_g, prod_cfg, wide=True, wide_layout=MAIN_LAYOUT
    )
    emit("scene", table_bytes=CT.table_bytes(scene),
         nl8_rows=scene.nl8.shape[0], triangles=scene.tri_pos.shape[0],
         instances=scene.inst_f.shape[0],
         main_path_wide_layout=MAIN_LAYOUT,
         main_path_wide_rows=list(prod_wide.wide_rows.shape),
         main_path_wide_table_bytes=CW.table_bytes(prod_wide))
    wide_scenes = phase_wide_scenes(scene_g)

    max_err, shapes, binary_out, bounded = phase_kernel_check(
        scene_g, rays_g, scene, prod_cfg, prod_scene
    )
    wide_err, wide_shapes, other_times = phase_wide_kernel_check(
        scene_g, rays_g, wide_scenes, binary_out, prod_cfg, prod_wide
    )
    phase_breakdown(prod_cfg, prod_scene, "binary")
    phase_breakdown(prod_cfg, prod_wide, "wide")
    gather_launches, gather_shapes, gather_sweep = phase_gather_probe(smi)
    return {k: v for k, v in locals().items() if k != "smi"}


def run_phases(t_start, smi, kind, built, early, demo) -> int:
    """main() past the build: every other phase, then the result lines.
    ``early``: early_phases' results; ``demo``: filled with the multihost
    demo's process once it starts."""
    scene_g, rays_g, scene, prod_cfg, prod_scene, prod_wide, wide_scenes = (
        early[k] for k in ("scene_g", "rays_g", "scene", "prod_cfg", "prod_scene",
                           "prod_wide", "wide_scenes"))
    max_err, shapes, binary_out = early["max_err"], early["shapes"], early["binary_out"]
    wide_err, wide_shapes, other_times = (early[k] for k in ("wide_err", "wide_shapes",
                                                             "other_times"))
    gather_launches, gather_shapes, gather_sweep = (
        early[k] for k in ("gather_launches", "gather_shapes", "gather_sweep"))
    bounded = early["bounded"]
    gather_one = gather_shapes[-1]  # the large table at one render tile's lanes
    oracle_mean = phase_oracle_frame(scene)
    phase_oracle_frame(wide_scenes[MAIN_LAYOUT], "oracle_frame_wide")
    phase_oracle_frame(wide_scenes[MAIN_LAYOUT], "oracle_frame_megakernel", megakernel=True)
    phase_oracle_frame(scene, "oracle_frame_wavefront", wavefront=True)
    motion_g = load_golden(str(GOLDEN / "motion.gold"))
    motion_wide = scene_device_from_motion_golden(motion_g, wide=True, wide_layout=MAIN_LAYOUT)
    # S10's multihost demo runs in processes of its own beside the two
    # check phases that take no time readings
    demo.update(start_multihost_demo())
    mk_err = phase_megakernel_check(wide_scenes[MAIN_LAYOUT], motion_wide)
    wf_err = phase_wavefront_check(
        {"binary": scene, **wide_scenes},
        {"binary": scene_device_from_motion_golden(motion_g), MAIN_LAYOUT: motion_wide},
    )
    multihost = phase_multihost_check(demo, smi)
    launches, colors, scan_sec = phase_main_path(prod_cfg, prod_scene, oracle_mean, wide=False)
    wide_launches, wide_colors, wide_sec = phase_main_path(
        prod_cfg, prod_wide, oracle_mean, wide=True, binary_colors=colors
    )
    mk_launches, mk_sec, mk_peak, _ = phase_main_path_fused(
        prod_cfg, prod_wide, oracle_mean, wide_colors, wide_sec, wavefront=False
    )
    wf_launches, wf_sec, wf_peak, wf_equal = phase_main_path_fused(
        prod_cfg, prod_scene, oracle_mean, colors, scan_sec, wavefront=True
    )
    # S10: pixel / sample sharding of the same frame
    shard = phase_shard_check(prod_cfg, prod_scene, prod_wide, smi)
    tonemap_res = phase_tonemap_check(prod_cfg, prod_wide)
    mk_time = phase_megakernel_timing(prod_cfg, prod_wide, smi)
    wf_time = phase_wavefront_timing(prod_cfg, prod_scene, prod_wide, smi)
    # S2: the bf16 node rows through P1 and K5 (the large and the animated
    # scene's in their phases), and the tuning table
    bf = phase_bf16_nodes_check(scene_g, rays_g, scene, prod_cfg, prod_scene, colors, shapes,
                                binary_out, built, smi)
    phase_tuning_check(smi)
    # S9: area lights through K2 and K5, the Cornell box and the adaptive /
    # AOV / denoise workflow (K8)
    lights = phase_arealight_check(smi)
    light_time = phase_arealight_timing(smi)
    cornell = phase_cornell_cli(smi)
    adaptive = phase_adaptive_cli(smi)
    dn = phase_denoise_check(smi)
    large = phase_large_scene(prod_cfg, smi)
    # S10: geometry sharding on the large scene's build
    geo = phase_geomshard_check(prod_cfg, large.pop("host"), binary_tables(large.pop("scene")),
                                smi)
    anim = phase_animation_cli(smi)  # with S10's hotperm_check and shard_cli
    rec_err = phase_record_check(wide_scenes, motion_wide)
    grad_k = phase_grad_kernel_check(prod_cfg, prod_wide, smi)
    phase_grad_slow_check(scene, wide_scenes[MAIN_LAYOUT])
    grad, grad_ref = phase_main_path_grad(prod_cfg, prod_wide, smi)
    sgrad = phase_shard_grad_check(prod_cfg, prod_wide, scene, grad_ref, smi)
    del grad_ref
    rec_time = phase_record_timing(prod_cfg, prod_wide, smi)
    # the path kernels' designs: where the cycles go, and the two designs
    # timed in this call
    prod_kinds = {"binary": prod_scene, MAIN_LAYOUT: prod_wide}
    for lay in LAYOUTS:
        if lay not in prod_kinds:
            prod_kinds[lay] = scene_device_from_golden(scene_g, prod_cfg, wide=True,
                                                       wide_layout=lay)
    split = phase_split(prod_cfg, prod_kinds, smi)
    designs = phase_design_timing(prod_cfg, prod_kinds, built, smi)

    emit("done", seconds=time.perf_counter() - t_start)
    # the batch launched max_bounces times of 1+max_bounces
    bounce, wbounce = shapes[1], wide_shapes[1]
    regs = lambda name: {
        "registers": [k["registers"] for k in built[name]["kernels"]],
        "spill_bytes": [k["spill_store_bytes"] + k["spill_load_bytes"]
                        for k in built[name]["kernels"]],
    }
    five = ("rays", "ms", "plain_ms", "bound_ms", "bound_by")
    fill = ("simd_efficiency", "simd_efficiency_packed", "active_warp_share")
    walk = lambda sh: {sh["shape"]: {k: sh[k] for k in fill}}
    print(json.dumps({"kernels": [
        {
            "name": "ray_query",
            "route": "cuda",
            "source": SOURCES["ray_query"],
            "replaces": "pathtracing_tpu/ops/pallas_traversal.py:64",
            "launches": launches,
            "max_abs_err": max_err,
            "ms": bounce["ms"],
            "plain_ms": bounce["plain_ms"],
            "bound_ms": bounce["bound_ms"],
            "bound_by": bounce["bound_by"],
            "library_ms": None,  # no single PyTorch call computes a BVH ray query
            "shape": f"bounce batch, {bounce['rays']} rays",
            "primary": {k: shapes[0][k] for k in five},
            # the query kernel's (the library's bounded kernel: ray_query_bounded)
            "registers_spills": built["ray_query"]["registers_spills"]["query"],
            "blocks_per_sm": built["ray_query"]["blocks_per_sm"],
            "lane_fill": {**walk(shapes[0]), **walk(bounce)},
            "large_scene": large_walk(large, "p1", "scan_binary"),
            # S10: the paths that run it per shard (launches of each run)
            "sharded": {"scan_2x2": shard["scan_binary"]["launches"],
                        "geomshard": {k: v["launches"] for k, v in geo.items()
                                      if isinstance(v, dict)},
                        "slow_gradient_1x2": sgrad["slow"]["launches"]["p1"],
                        "multihost_hosts": [x["launches"]["ray_query"]
                                            for x in multihost["hosts"]]},
            # the animated frame loop: load_scene's placement in every CLI
            # process, and the in-process scan frames on the frame tables
            "animation_cli": {
                "launches_load_scene": anim["cli"]["frames64"]["load"]["launches"]["ray_query"],
                "scan_frame_seconds": {f: v["scan_binary"]["seconds"]
                                       for f, v in anim["frames"].items()}},
            "card": smi,
        },
        {
            # P1's bounded query: the same library's second kernel
            "name": "ray_query_bounded",
            "route": "cuda",
            "source": SOURCES["ray_query"],
            "replaces": "pathtracing_tpu/ops/pallas_traversal.py:64",
            # the JAX walk's bounded loop, which the Pallas body runs
            "bounded_loop_of": "pathtracing_tpu/ops/traversal.py:546",
            # the completion-step sweep through ray_query (bounded_walk_check)
            "launches": bounded["nl8"]["launches"],
            "max_abs_err": 0.0,  # every state field bit-equal, or the phase raised
            "ms": bounded["nl8"]["ms"],
            "plain_ms": bounded["nl8"]["plain_ms"],
            "bound_ms": bounded["nl8"]["bound_ms"],
            "bound_by": bounded["nl8"]["bound_by"],
            "library_ms": None,  # no single PyTorch call computes a BVH ray query
            "shape": (f"golden bounce batch, {bounce['rays']} rays, max_steps = the "
                      f"longest lane's {bounded['nl8']['longest_steps']}, the walk state"),
            "query_ms_same_call": bounded["nl8"]["query_ms_same_call"],
            "registers_spills": built["ray_query"]["registers_spills"]["bounded"],
            "nl5": {k: bounded["nl5"][k] for k in ("launches", "ms", "plain_ms",
                                                   "query_ms_same_call", "longest_steps",
                                                   "completion_steps_upper")},
            "nl5_registers_spills": built["ray_query_nl5"]["registers_spills_bounded"],
            "completion_steps_upper": bounded["nl8"]["completion_steps_upper"],
            "checks": {rows: bounded[rows]["checks"] for rows in ("nl8", "nl5")},
            "card": smi,
        },
        {
            "name": "ray_query_nl5",
            "route": "cuda",
            "source": SOURCES["ray_query_nl5"],
            "replaces": "pathtracing_tpu/ops/pallas_traversal.py:64",
            # the Pallas body reads nl8 rows; the XLA walk it shares reads
            # nl5 rows here
            "reads_rows_as": "pathtracing_tpu/ops/traversal.py:172",
            "build": "ray_query.cu with -DPT_NODE_ROWS=5",
            # the nl5 scan frame's launches (bf16_nodes_check)
            "launches": bf["scan_launches"],
            "max_abs_err": bf["max_abs_err"],
            "ms": bf["timing"]["bounce"]["nl5"]["ms"],
            "plain_ms": bf["batches"]["bounce"]["as_captured"]["plain_ms"],
            "bound_ms": bf["timing"]["bounce"]["nl5"]["bound_ms"],
            "bound_by": bf["timing"]["bounce"]["nl5"]["bound_by"],
            "library_ms": None,  # no single PyTorch call computes a BVH ray query
            "shape": f"bounce batch, {bf['timing']['bounce']['rays']} rays",
            "device_ms": bf["timing"]["bounce"]["nl5"]["device_ms"],
            "nl8_ms_same_call": bf["timing"]["bounce"]["nl8"]["ms"],
            "nl8_device_ms_same_call": bf["timing"]["bounce"]["nl8"]["device_ms"],
            "primary": {k: bf["timing"]["primary"]["nl5"][k]
                        for k in ("ms", "device_ms", "bound_ms", "bound_by")},
            "primary_nl8_ms_same_call": bf["timing"]["primary"]["nl8"]["ms"],
            "scan_frame": bf["frames"]["scan"],
            "registers_spills": built["ray_query_nl5"]["registers_spills"],
            "blocks_per_sm": built["ray_query_nl5"]["blocks_per_sm"],
            "large_scene": {k: large["nl5"]["timing"][k] for k in ("primary", "bounce")},
            "large_scene_tile": large["nl5"]["tile_timing"],
            "card": smi,
        },
        {
            "name": "wide_ray_query",
            "route": "cuda",
            "source": SOURCES["wide_ray_query"],
            "replaces": "pathtracing_tpu/ops/wide_traversal.py:672",
            "layout": MAIN_LAYOUT,
            "launches": wide_launches,
            "max_abs_err": wide_err,
            "ms": wbounce["ms"],
            "plain_ms": wbounce["plain_ms"],
            "bound_ms": wbounce["bound_ms"],
            "bound_by": wbounce["bound_by"],
            "library_ms": None,  # no single PyTorch call computes a BVH ray query
            "p1_ms_same_batch": wbounce["p1_ms_same_batch"],
            "shape": f"bounce batch, {wbounce['rays']} rays",
            "primary": {k: wide_shapes[0][k] for k in five + ("p1_ms_same_batch",)},
            "other_layouts_primary_ms": other_times,
            **regs("wide_ray_query"),
            "blocks_per_sm": built["wide_ray_query"]["blocks_per_sm"],
            "lane_fill": {**walk(wide_shapes[0]), **walk(wbounce)},
            "large_scene": large_walk(large, "k1", "scan_w8"),
            "sharded": {"scan_w8_2x2": shard["scan_w8"]["launches"],
                        "hotperm_batches": anim["hotperm"]["k1_launches"]},
            "animation_chunked": [{k: sh[k] for k in five + ("max_abs_err", "p1_ms_same_batch",
                                                             "id_mismatches_vs_ray_query")}
                                  for sh in anim["k1"]],
            # S11: the packer's options on the same frame and batches
            "packer_options": {
                "launches": anim["options"]["launches"]["k1"],
                **{k: {b: v[f"k1_{b}"] for b in ("primary", "bounce")}
                   for k, v in anim["options"]["packs"].items()}},
            "card": smi,
        },
        {
            "name": "gather_rows",
            "route": "cuda",
            "source": SOURCES["gather_rows"],
            "replaces": "tools/gather_probe.py:76",
            "launches": gather_launches,
            "max_abs_err": 0.0,  # bit-equal to index_select, or the phase raised
            "ms": gather_one["ms"],
            # the plain version IS the one PyTorch call: index_select
            "plain_ms": gather_one["index_select_ms"],
            "bound_ms": gather_one["bound_ms"],
            "bound_by": gather_one["bound_by"],
            "library_ms": gather_one["index_select_ms"],
            "shape": (f"table {gather_one['table']}, {gather_one['lanes']} rows, "
                      f"k={gather_one['k']}"),
            "device_ms": gather_one["device_ms"],
            "count_pass_device_ms": gather_one["count_pass_device_ms"],
            "shapes": [{k: sh[k] for k in ("table", "lanes", "buckets", "ms", "device_ms",
                                           "bound_ms", "index_select_ms",
                                           "index_select_device_ms")}
                       for sh in gather_shapes],
            "k_sweep_ms": {k: v["ms"] for k, v in gather_sweep.items()},
            **regs("gather_rows"),
            "card": smi,
        },
        {
            "name": "megakernel",
            "route": "cuda",
            "source": SOURCES["megakernel"],
            "replaces": "pathtracing_tpu/ops/megakernel.py:554",
            "layout": MAIN_LAYOUT,
            "launches": mk_launches,
            "max_abs_err": mk_err,
            "ms": mk_time["ms"],
            # the scan frame's time on the same scene (main_path_wide)
            "plain_ms": wide_sec * 1e3,
            "bound_ms": mk_time["bound_ms"],
            "bound_by": mk_time["bound_by"],
            "library_ms": None,  # no single PyTorch call renders a path
            "shape": f"{prod_cfg.image_width}x{prod_cfg.image_height} x {MAIN_SPP} spp, "
                     f"{prod_cfg.max_bounces} bounces, one launch",
            "frame_seconds": mk_sec,
            "msamples_per_s": prod_cfg.image_width * prod_cfg.image_height * MAIN_SPP
                              / mk_sec / 1e6,
            "peak_memory_allocated_bytes": int(mk_peak),
            **regs("megakernel"),
            "registers_spills_timed_builds": {
                d: built["megakernel"]["registers_spills_by_layout"][d] for d in K2_TIMED},
            "blocks_per_sm_first_design": built["megakernel"]["blocks_per_sm"],
            **design_summary("megakernel", designs, split),
            "large_scene": large_path(large, "k2_w8", "megakernel_w8"),
            "sharded": {**{m: shard[f"megakernel_{m}"]["launches"]
                           for m in ("4x1", "2x2", "1x4")},
                        "hotperm": anim["hotperm"]["k2_launches"],
                        "hotperm_ms": anim["hotperm"]["k2_ms"]},
            "animation_cli": {**anim_kernel(anim, "frames64", "megakernel"),
                              f"frame_{ANIM_DEEP_SPP}_spp": anim_kernel(anim, ANIM_DEEP,
                                                                        "megakernel"),
                              "launch_at_frame_dispatch": anim["k2_launch"],
                              "traced_first_frame": {
                                  tag: anim["cli"][tag]["frames"][0]["traced"]
                                  for tag in ("frames64", ANIM_DEEP)},
                              "last_subframes_vs_scan": {
                                  spp: v["k2_vs_scan"] for spp, v in anim["subframes"].items()}},
            # S11: one 2 spp launch a pack, timed in turns
            "packer_options": {
                "launches": anim["options"]["launches"]["k2"],
                **{k: {key: v[key] for key in ("wide_rows", "wide_bytes", "k2_ms", "device_ms")
                       if key in v} | ({"vs_base": v["k2_vs_base"]} if "k2_vs_base" in v
                                       else {})
                   for k, v in anim["options"]["packs"].items()},
                "build_tlas_trees": anim["options"]["build_tlas_trees"]},
            "card": smi,
        },
        {
            "name": "wavefront",
            "route": "cuda",
            "source": SOURCES["wavefront"],
            "replaces": "pathtracing_tpu/ops/wavefront.py:83",
            "layout": "binary",
            "launches": wf_launches,
            "max_abs_err": wf_err,
            "ms": wf_time["binary"]["ms"],
            # the scan frame's time on the same scene (main_path)
            "plain_ms": scan_sec * 1e3,
            "bound_ms": wf_time["binary"]["bound_ms"],
            "bound_by": wf_time["binary"]["bound_by"],
            "library_ms": None,  # no single PyTorch call renders a path
            "shape": f"{prod_cfg.image_width}x{prod_cfg.image_height} list x {MAIN_SPP} spp, "
                     f"{prod_cfg.max_bounces} bounces, one launch",
            "w8": {k: wf_time["w8"][k] for k in ("ms", "bound_ms", "bound_by",
                                                 "k2_w8_ms_same_call")},
            "frame_seconds": wf_sec,
            "msamples_per_s": prod_cfg.image_width * prod_cfg.image_height * MAIN_SPP
                              / wf_sec / 1e6,
            "peak_memory_allocated_bytes": int(wf_peak),
            "frame_bit_equal_share_vs_scan": wf_equal,
            **regs("wavefront"),
            "registers_spills_by_layout": built["wavefront"]["registers_spills_by_layout"],
            "blocks_per_sm_first_design": built["wavefront"]["blocks_per_sm"],
            **design_summary("wavefront", designs, split),
            "large_scene": large_path(large, "k5_binary", "wavefront_binary"),
            "large_scene_w8": large_path(large, "k5_w8", "wavefront_w8"),
            "sharded": {**{m: shard[f"wavefront_{m}"]["launches"]
                           for m in ("4x1", "2x2", "1x4")},
                        "render_frame_sharded": shard["render_frame_sharded"]["launches"],
                        "cli_shard": anim["cli"]["shard"]["frames"][0]["launches"]["wavefront"]},
            "tonemap_check": tonemap_res,
            "animation_cli": {**anim_kernel(anim, "wavefront64", "wavefront"),
                              "last_subframes_vs_scan": {
                                  spp: v["k5_binary_vs_scan"]
                                  for spp, v in anim["subframes"].items()}},
            # S11: one w8 launch a pack, each bit-equal to K2 on it
            "packer_options": {"launches": anim["options"]["launches"]["k5"],
                               "equal_to_k2": True},
            "card": smi,
        },
        {
            "name": "wavefront_nl5",
            "route": "cuda",
            "source": SOURCES["wavefront_nl5"],
            "replaces": "pathtracing_tpu/ops/wavefront.py:83",
            "reads_rows_as": "pathtracing_tpu/ops/traversal.py:172",
            "build": "wavefront.cu with -DPT_NODE_ROWS=5",
            "layout": "binary, nl5 rows",
            # the nl5 K5 frame's launches (bf16_nodes_check)
            "launches": bf["wf_launches"],
            "max_abs_err": bf["max_abs_err_k5"],
            "ms": bf["k5"]["nl5"]["ms"],
            # the scan frame on nl5 rows, the plain version of the same work
            "plain_ms": bf["scan_seconds"] * 1e3,
            "bound_ms": bf["k5"]["nl5"]["bound_ms"],
            "bound_by": bf["k5"]["nl5"]["bound_by"],
            "library_ms": None,  # no single PyTorch call renders a path
            "shape": f"{prod_cfg.image_width}x{prod_cfg.image_height} list x {MAIN_SPP} spp, "
                     f"{prod_cfg.max_bounces} bounces, one launch",
            "device_ms": bf["k5"]["nl5"]["device_ms"],
            "nl8_ms_same_call": bf["k5"]["nl8"]["ms"],
            "nl8_device_ms_same_call": bf["k5"]["nl8"]["device_ms"],
            "frame": bf["frames"]["wavefront"],
            "registers_spills": built["wavefront_nl5"]["registers_spills_by_layout"],
            "blocks_per_sm": built["nl5_blocks_per_sm"]["wavefront_nl5"],
            "large_scene": {k: large["nl5"]["k5"][k] for k in (
                "nl5", "nl8", "nl5_vs_reference", "nl5_vs_nl8", "nl5_over_nl8_ms")},
            "animation_frame": {k: anim["nl5"][k] for k in (
                "frame", "tables", "nl5", "nl8", "nl5_vs_reference", "nl5_vs_nl8",
                "nl5_over_nl8_ms")},
            "card": smi,
        },
        {
            "name": "wavefront_nl5_arealights",
            "route": "cuda",
            "source": SOURCES["wavefront_nl5_lit"],
            "replaces": "pathtracing_tpu/ops/wavefront.py:106",
            "reads_rows_as": "pathtracing_tpu/ops/traversal.py:172",
            "build": "wavefront.cu with -DPT_NODE_ROWS=5 -DPT_AREA_LIGHTS=1",
            "layout": "binary, nl5 rows",
            # the Cornell box's nl5 K5 frame through render_frame
            "launches": bf["lit"]["launches"]["nl5"],
            "max_abs_err": bf["max_abs_err_lit"],
            "ms": bf["lit"]["launch"]["nl5"]["ms"],
            "plain_ms": bf["lit"]["plain_ms"],
            "bound_ms": bf["lit"]["launch"]["nl5"]["bound_ms"],
            "bound_by": bf["lit"]["launch"]["nl5"]["bound_by"],
            "library_ms": None,  # no single PyTorch call renders a path
            "shape": f"Cornell box 1920x1080 list x {MAIN_SPP} spp, 5 bounces, one launch",
            "device_ms": bf["lit"]["launch"]["nl5"]["device_ms"],
            "nl8_ms_same_call": bf["lit"]["launch"]["nl8"]["ms"],
            "frame_vs_nl8": bf["lit"]["frame_vs_nl8"],
            "card": smi,
        },
        {
            "name": "megakernel_record",
            "route": "cuda",
            "source": SOURCES["megakernel"],
            "replaces": "pathtracing_tpu/ops/megakernel.py:554",
            "layout": MAIN_LAYOUT,
            "launches": grad["launches"]["k6"],
            # at the main path's shape: records equal exactly; the sums
            # against the plain version's (record_check's smaller cases beside)
            "max_abs_err": rec_time["max_abs_err"],
            "max_abs_err_record_check": rec_err,
            "ms": rec_time["ms"],
            "plain_ms": rec_time["plain_ms"],
            "bound_ms": rec_time["bound_ms"],
            "bound_by": rec_time["bound_by"],
            "library_ms": None,  # no single PyTorch call renders a path
            "shape": f"{prod_cfg.image_width}x{prod_cfg.image_height} x {GRAD_SPP} spp, "
                     f"{prod_cfg.max_bounces} bounces, one launch, records",
            "k2_ms_same_call": rec_time["k2_ms_same_call"],
            "registers_spills_by_layout": {
                d: built["megakernel"]["registers_spills_by_layout"][f"record_{d}"]
                for d in CM.DESIGNS},
            "design_timing_w8": {d: designs["megakernel_record_w8_row_major"][d]["ms"]
                                 for d in CM.DESIGNS},
            "large_scene": {k: large["k6"][k] for k in (
                "launches", "ms", "device_ms", "bound_ms", "bound_by", "max_abs_err",
                "primary_hit_share")},
            "sharded_fast_gradient": sgrad["fast"]["launches"]["k6"],
            "card": smi,
        },
        {
            "name": "small_table_grad",
            "route": "cuda",
            "source": str(CG.SOURCE.relative_to(ROOT)),
            "replaces": "pathtracing_tpu/ops/integrator.py:55",
            "launches": grad["launches"]["k7a"],
            "max_abs_err": grad_k["max_abs_err"]["small_table_grad"],
            **grad_kernel_entry(grad_k["small_table_grad"]),
            "onehot_matmul_ms": grad_k["small_table_grad"]["onehot_matmul_ms"],
            "sharded_gradients": {"fast": sgrad["fast"]["launches"]["k7a"],
                                  "slow": sgrad["slow"]["launches"]["k7a"]},
            **regs("gather_grad"),
            "card": smi,
        },
        {
            "name": "row_grad",
            "route": "cuda",
            "source": str(CG.SOURCE.relative_to(ROOT)),
            "replaces": "pathtracing_tpu/ops/integrator.py:132",
            "launches": grad["launches"]["k7b"],
            "max_abs_err": grad_k["max_abs_err"]["row_grad"],
            # the vattr transpose of the timed shade; its inst_f and
            # tri_pos transposes beside, and tri_pos into a table sorted in
            # two passes
            **grad_kernel_entry(grad_k["row_grad_vattr"]),
            **{tab: {**grad_kernel_entry(grad_k[f"row_grad_{tab}"]),
                     "passes": grad_k[f"row_grad_{tab}"]["passes"]}
               for tab in ("inst_f", "tri_pos", "tri_pos_two_pass")},
            "sharded_gradients": {"fast": sgrad["fast"]["launches"]["k7b"],
                                  "slow": sgrad["slow"]["launches"]["k7b"]},
            **regs("gather_grad"),
            "card": smi,
        },
        {
            "name": "megakernel_arealights",
            "route": "cuda",
            "source": SOURCES["megakernel"],
            "replaces": "pathtracing_tpu/ops/megakernel.py:85",
            "layout": MAIN_LAYOUT,
            # the Cornell box's 64 spp CLI frame: one launch a dispatch
            "launches": cornell["cornell64"]["launches"],
            "max_abs_err": lights["max_abs_err"]["megakernel"],
            "ms": light_time["k2_w8"]["ms"],
            # the scan on the same work (the binary tables)
            "plain_ms": light_time["plain_ms"],
            "bound_ms": light_time["k2_w8"]["bound_ms"],
            "bound_by": light_time["k2_w8"]["bound_by"],
            "library_ms": None,  # no single PyTorch call renders a path
            "shape": f"Cornell box 1920x1080 x {MAIN_SPP} spp, 5 bounces, one launch",
            "device_ms": light_time["k2_w8"]["device_ms"],
            "registers_spills": {d: built["megakernel"]["registers_spills_by_layout"][
                f"lit_{d}"][MAIN_LAYOUT] for d in CM.DESIGNS},
            "cli_frame_64spp": cornell["cornell64"],
            "light_rows": lights["lights"],
            "card": smi,
        },
        {
            "name": "wavefront_arealights",
            "route": "cuda",
            "source": SOURCES["wavefront"],
            "replaces": "pathtracing_tpu/ops/wavefront.py:106",
            "layout": MAIN_LAYOUT,
            "launches": cornell["cornell64_wavefront"]["launches"],
            "max_abs_err": lights["max_abs_err"]["wavefront"],
            "ms": light_time["k5_w8"]["ms"],
            "plain_ms": light_time["plain_ms"],
            "bound_ms": light_time["k5_w8"]["bound_ms"],
            "bound_by": light_time["k5_w8"]["bound_by"],
            "library_ms": None,  # no single PyTorch call renders a path
            "shape": f"Cornell box 1920x1080 list x {MAIN_SPP} spp, 5 bounces, one launch",
            "device_ms": light_time["k5_w8"]["device_ms"],
            "binary": {k: light_time["k5_binary"][k]
                       for k in ("ms", "device_ms", "bound_ms", "bound_by")},
            "registers_spills": {d: {kind: built["wavefront"]["registers_spills_by_layout"][
                f"lit_{d}"][kind] for kind in ("binary", MAIN_LAYOUT)} for d in CM.DESIGNS},
            "cli_frame_64spp": cornell["cornell64_wavefront"],
            "adaptive_cli": adaptive["cli"],
            "adaptive_pass2_640x360": adaptive["pass2_640x360"],
            "card": smi,
        },
        {
            "name": "denoise",
            "route": "cuda",
            "source": str(CD.SOURCE.relative_to(ROOT)),
            "replaces": "pathtracing_tpu/denoise.py:36",
            "launches": dn["launches"],
            "max_abs_err": dn["max_abs_err"],
            "ms": dn["timing"][2]["ms"],
            "plain_ms": dn["timing"][2]["plain_ms"],
            "bound_ms": dn["timing"][2]["bound_ms"],
            "bound_by": dn["timing"][2]["bound_by"],
            "library_ms": None,  # no single PyTorch call is a joint bilateral filter
            "shape": "1920x1080 x 3, radius 2, the noise map",
            "design": dn["timing"][2]["design"],
            "device_ms": dn["timing"][2]["device_ms"],
            "radius_4": {k: dn["timing"][4][k] for k in ("ms", "device_ms", "plain_ms",
                                                         "bound_ms", "bound_by", "design")},
            "launches_by_design": dn["launches_by_design"],
            "past_tile_radius": dn["past_tile_radius"],
            "quality": dn["quality"],
            "registers_spills": dn["registers"],
            "card": smi,
        },
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
