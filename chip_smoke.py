#!/usr/bin/env python3
"""On-card check of the PyTorch port (``pyimsegm_tpu_torch``).

Run from the root of a checkout on a machine with one CUDA card::

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):

1. the card's name and power limit, as ``nvidia-smi`` reports them;
2. build the CUDA kernels from ``pyimsegm_tpu_torch/csrc`` (one nvcc per
   source, all started together, into ``build/torch_kernels/``) and print
   the build seconds;
3. for each kernel, at the bench geometry (884x1200, sp_size 35, regul 0.2)
   on the labels the SLIC kernels produce: kernel and plain PyTorch twin on
   the same inputs on the card, agreement within the stated tolerance, and
   both times; row 1 (at most 2 CUDA kernels and no host-to-device copy a
   call) at 884x1200 and on ``PREP_SHAPES`` (883x1197, widths no multiple
   of 4 or 32, images smaller than the blur radius, both tiles), on image 0
   as gray, in 0-255 and with one NaN pixel, and on a constant image (bf16
   values equal on >= 0.9999 of them, at most 1 ulp, NaN where the twin is
   NaN), each call twice with equal bits (``prep_phases``); row 10 (at most
   2 CUDA kernels a call: the pass and its route to per-seed counts and
   symmetric contacts) exact against its twins, (cnt9, counts9) and the
   routed triple, on SLIC and enforced labels of image 0 and of the noise
   image, damaged labels (-1, -2, out of the window, >= K) at 884x1200 and
   883x1197, and both tiles, each call twice with equal bits
   (``minsize_count_phases``); row 11 (at most 2 CUDA kernels a call: the
   presence pass and its route to the symmetric (gh, gw, 25) adjacency)
   exact against its twins, the words and the routed adjacency, on the
   same label sets (and the damaged labels of the noise image and at
   71x106); row 9 exact at C = 1 (int32 and f32), 2, 3, 4 and 5 on the
   labels and on damaged labels; row 12 exact on the noise image's labels
   and on ``ENFORCE_CASES`` (fragmented noise labels, a tall image, the
   serpentine labels that need more reach sweeps than the cap, which must
   stop at the cap); rows 2 (plain and SLICO, centres within 1e-3) and 8
   (merged labels exact, sums within rtol 1e-5) again at an odd geometry,
   883x1197 (the width not a multiple of 4, the last tile row and column
   partial), from seeds of which one wins no pixel, whose empty cluster must
   keep its centre; every row 2 call must be one C call of the wrapper;
   row 3 writes labels, partials and their routed per-seed sums (routed
   sums within the partials' tolerance, at most 2 CUDA kernels per call);
   then, for rows 1-12 and 15 as the paths call them (row 1 as
   ``_prepare_chw`` calls it, row 3 with its routing, row 10 as the bench
   path's ``counts_and_contacts``, row 11 as the edge weights'
   ``grid_adjacency``, and the bench path's whole SLIC stage), the call ms, the
   device ms and the CUDA kernels per call from ``torch.profiler`` on the
   labels of image 0 and of the noise image and on the 3D workload, row 9
   at C = 1 and 4 beside ``table[index]``, rows 6 (F = 7 f32 and bf16,
   F = 4 f32, F = 30 bf16) and 7 (F = 3, 18, 60) on image 0
   (``measure_path_kernels``);
4. the ``connectivity=False`` path: three synthetic 884x1200 images through
   ``segment_color2d_slic_features_model_graphcut(..., connectivity=False)``
   with the GMM class model of ``tests/data/torch_port_fixture.npz``; each
   of its kernels must have launched, and image 0 must agree with the
   stored JAX-CPU result (segmentation ARS >= 0.98, SLIC labels >= 0.999);
5. the bench path: image 0 through the same call at its default
   ``connectivity=True`` against ``tests/data/torch_port_fixture_conn.npz``
   (ARS >= 0.98, enforced labels >= 0.999 equal), then eight images through
   ``parallel.batch.segment_images_batch``, image i equal to the
   single-image call on image i; all eight kernels of the path must have
   launched, the SLIC schedule once per image; warm ms per image and
   MPix/s; then ``bench.py``'s first two
   noise images against ``tests/data/torch_port_fixture_noise.npz`` (SLIC
   labels >= 0.999, enforced labels >= ``NOISE_ENFORCED_BAR``, ARS >= 0.98);
6. the enforcement op with centroids reduced from the labels
   (``ops.grid.enforce_grid_connectivity(..., centers=None)``), which runs
   the donor-less moments kernel;
7. the kernels of the fit path against their twins: the labels-only
   assignment, plain and SLICO (labels exact), the partials-only pass
   (rtol 1e-5), the SLICO multi-update (centres and colour normalisers),
   and the grid reduce at F = 3, 4, 7, 15, 30, 40 on f32 and bf16 data
   (rtol 1e-5 plus 1e-5 of the channel's largest sum, at most 2 CUDA
   kernels a call);
   then rows 6 and 7 (``reduce_phases``) at 884x1200 and at ODD, on the
   SLIC kernels' labels and on damaged ones (-2 holes, ids outside their
   window, ids >= K inside and beyond the windows), row 6 at F = 1, 3, 4,
   5, 7, 15, 30, 40, 61 in f32 and bf16, row 7 at F = 1, 3, 5, 18, 60,
   61, both also beyond one block's channels (F = 129 at 4-byte loads, row
   6 at 258 and both at 260 at 8- and 16-byte loads: two channel ranges),
   each call twice with equal bits, within the same bar; then rows 6, 7,
   10 and 11 at seed steps above their former caps (``step_phases``: row
   7 at 1025, 2100 and 3500, rows 10 and 11 at 4097, row 6 at 16385) on
   grid-structured labels made with numpy, each call twice with equal
   bits, counts exact and sums within the same bar;
8. the fit path: image 0 through
   ``pipe_color2d_slic_features_model_graphcut`` with the full colour
   feature set (mean, std, energy, median, meanGrad), a GMM fitted on the
   card, against ``tests/data/torch_port_fixture_fit.npz`` (enforced labels
   >= 0.999 equal, features, segmentation ARS >= 0.98, the fit's weighted
   mean log-likelihood on the JAX features within 1e-3 relative of the JAX
   fit's); the same image segmented with the JAX-fitted model (ARS >=
   0.98); SLICO labels of ``segment_slic_img2d`` (>= 0.999); one
   ``gc_edge_type='color'`` call; ``estim_model_classes_group`` on three
   images, then ``segment_images_batch`` with that model; warm ms per image
   with the fit, and the fit's own ms;
9. the 3D gray-volume path at the repo's 3D workload (48x640x768, spacing
   (4, 1, 1), sp_size 15, regul 0.2, gc_regul 0.1, 2 classes): the 3D SLIC
   labels pass (exact) and partials pass (rtol 1e-5) against their twins
   on the same centres, the whole ``slic3d_iterate`` (one cooperative
   launch, one CUDA kernel per schedule) against its twin on the structured
   volume of ``sample_gray_volume_3d`` (>= 0.999 of labels equal) and on
   ``bench_all.py``'s noise volume (reported), each schedule run twice with
   equal labels; the passes and the schedule also on ``CASES_3D`` (50
   tiles, under one wave of co-resident blocks; a shape no multiple of the
   steps with one seed forced empty, which must stay empty; tiles of more
   rows than a block has threads); then
   ``pipe_gray3d_slic_features_model_graphcut`` on the structured volume
   against ``tests/data/torch_port_fixture_3d.npz`` (SLIC labels of the
   stored slices >= 0.999 equal, segmentation ARS >= 0.98; the supervoxels
   whose voxel sets JAX's labelling has too, by the fixture's digest, at
   least ``SAME_SETS_3D`` of all, and their standardised features within
   the ``*_3D`` bars below; one ``slic3d_iterate`` launch per volume and no
   standalone pass; the card fit's weighted mean log-likelihood,
   on the JAX features and on the card's own, within 1e-3 relative of the
   JAX fit's on the same features), the edge count against the
   reference's 8K capacity
   and the count of edges 3 cells apart, and warm ms per volume and MVox/s;
10. the supervised 2D path (BASELINE config 2: colour + tGabor + tLBP
   features, random forest, gc_regul 5.0) and the wide-image connectivity
   route: (a) rows 13 (``reach_absorb``, 4096x4096) and 14
   (``reach_absorb_fused``, 2048x3600) at sp_size 35 on the SLIC kernels'
   labels of a synthetic tile, from the anchor seed, each against its twin
   and against row 12 on the same labels and centres (exact), with the
   launches per call and the grid passes run, and row 2's schedule, plain
   and SLICO, on each tile against its twin (centres within 1e-3); (b) row 7 at F = 18 and 60
   against its twin; (c) config 2 at the bench geometry with the JAX-trained
   forest of ``tests/data/torch_port_fixture_sup.npz`` carried across,
   against the fixture's image 0 (enforced labels >= 0.999 equal, feature
   names equal, features of unchanged superpixels within rtol 1e-5 + 1e-4,
   their proba within 1e-6, segm ARS >= 0.98), and once with the tLM
   family's forest (features and ARS); (d)
   ``train_classif_color2d_slic_features`` on the card on images 0-2 with a
   3-candidate search (accuracy on the JAX training set and image 0's ARS
   against its annotation within 0.02 of the JAX forest's; two fits with
   one seed equal); (e) a 2048x3600 and a 4096x4096 tile segmented with
   that forest, which must launch row 14 and row 13 and not row 12; warm
   ms per tile and MPix/s;
11. the rest of the supervised family and the steps beyond the kernels'
   former limits: (a) row 15 in its banded mode (``BIG_STEPS_3D``, seed
   steps whose unbanded layout exceeds the card's shared memory a block),
   its passes against their twins on the seeds and on the centres after a
   round (those centres within 1e-5 of |centre| + 10), the schedule twice
   equal and against
   its twin (>= 0.999); (b) the 3D path with LM texture
   (``FEATURES_3D_TLM``) against ``tests/data/torch_port_fixture_3d_tlm.npz``
   at 8x160x192 (labels >= 0.999, ARS >= 0.98, standardised features of
   the supervoxels whose voxel sets agree within 1e-2), then at the 3D
   workload, timed, launching one ``slic3d_iterate`` a volume, its
   features finite (its GMM fit, NaN on the card, reported: ROADMAP.md
   queue 3); (c) config
   2 with each of ``CLF_FAMILIES`` trained by the JAX package and carried
   from ``tests/data/torch_port_fixture_clf.npz`` (names equal, labels >=
   0.999, features of unchanged superpixels within rtol 1e-5 + 1e-4, their
   proba within ``PROBA_FAMILY_BAR`` on all but ``PROBA_FAMILY_SHARE`` of
   them, ARS >= 0.98, warm ms); (d) each family trained on the card on
   images 0-2 with a 3-candidate search (accuracy on the JAX training set
   within 0.02 of JAX's; GradBoost's fit twice with equal parameters,
   AdaBoost's compared and reported; training ms); (e) row 8 at step
   46341, one tile of more than 2^31 pixels, K = 1, no merge: the pixel
   count equal to the tile's pixels rounded once to f32, sum f within
   rtol 1e-3 of a float64 reduction, and the anchor seed of rows 13 / 14
   on the same labels, whose one anchor is the centre pixel; then a line
   saying whether scipy and pandas import on this machine;
12. centre detection and ellipse fitting (BASELINE config 4) at the ovary
   image's size, 647x1024, on the synthetic scenes of
   ``sample_ovary_scene`` against ``tests/data/torch_port_fixture_centers.npz``:
   (a) rows 1, 2, 4, 6, 7, 9, 10 and 12 against their twins at sp_size 25
   on the colour scene and at sp_size 15 on the gray segmentation (last
   tile rows and columns partial) (``slice_kernel_phases``); (b) the fused
   ``load_compute_detect_centers`` with the JAX-trained forest carried
   across (``path_centers``: SLIC labels >= 0.999, the same non-empty
   superpixels, points and the histograms at them exact on those whose
   pixels agree, raw rays equal on >= ``RAY_BAR`` of entries,
   shifts on >= ``SHIFT_BAR`` of rows with the aligned rays equal there,
   centres one to one within 1 px, recall and precision against the true
   centres at least JAX's; warm ms, the device ms of each
   ``pyimsegm:<stage>`` range and the CUDA kernels of one call); (c)
   ``train_center_classifier`` on three scenes with one search candidate,
   its forest's detection within one centre of the JAX forest's (TP, FP),
   training ms (``path_train_centers``); (d) the ellipse chain on the true
   centres: gray SLIC at sp_size 15, ray-edge boundary points, RANSAC under
   ``np.random.seed(0)`` with the example's table, ``add_overlap_ellipse``
   (labels >= 0.999, points >= ``RAY_BAR``, parameters within 1e-6
   relative where the inlier counts agree, object map >= 0.999; warm ms)
   (``path_ellipses``);
13. region growing with shape priors (BASELINE config 5) at 647x1024 on the
   test scene against ``tests/data/torch_port_fixture_rg2sp.npz``: (a)
   rows 1, 2, 4, 6, 7, 9, 10 and 12 against their twins at sp_size 15 on
   the colour scene (``slice_kernel_phases``); (b) the SLIC on the card,
   then GraphCut RG2Sp with the JAX-fitted shape model carried across
   (``path_rg2sp``: SLIC labels >= 0.999, each egg's object pixel IoU >=
   ``RG_IOU_BAR`` against JAX's and its IoU with the true egg at most
   ``RG_TRUE_SLACK`` below JAX's, the iteration count within
   ``RG_ITER_SLACK`` of JAX's; the route the labels take, warm ms per
   call and per iteration, the stage device ms, device busy ms and idle
   share), on the test scene (the edge-list solve) and on a second one
   whose labels take the grid solve; (c) greedy RG2Sp, the chain with the
   SLIC on the card against the port's CPU greedy on that SLIC, then on
   JAX's SLIC against JAX's (the object and iteration bars both)
   (``path_rg2sp_greedy``); (d) the shape model
   fitted on the card from the training scenes' eggs, and RG2Sp with it
   (``path_rg2sp_fitted``: rays equal to JAX's, JAX's component count and
   the true-egg bar); (e) the
   one-shot object GraphCuts on the superpixels (object map >= 0.99) and
   on the 662,528 pixels (energy at most ``RG_ENERGY_SLACK`` above JAX's)
   (``path_object_graphcuts``); (f) the compat SLIC (raw labels >=
   ``COMPAT_RAW_BAR``), its host postprocess (exact) and ``sp_compat``
   (ARS >= ``COMPAT_ARS_BAR``) (``path_compat``);
14. the rest of the single-card modules after the ovary zoo's SLIC
   (``path_rest``) on the test scene against
   ``tests/data/torch_port_fixture_rest.npz``: the zoo's SLIC (sp_size
   40, regul 0.3; rows 1, 2, 4, 7, 9, 10 and 12; labels >= 0.999), its
   ``morph-snakes_img`` and ``morph-snakes_seg`` (``path_snakes``: labels
   >= ``SNAKE_BAR`` equal to JAX's, each object's IoU >= ``SNAKE_IOU_BAR``,
   the card's run cut to ``SNAKE_CPU_ITER`` iterations against the port's
   CPU run; warm ms, ``utils.profiling.time_jitted`` ms, CUDA kernels and
   idle share per call), the descriptor API on the card's labels against
   the numpy twins, the five colour inverses at 884x1200 against the CPU
   run and the round trip, the annotation quantisation (exactly JAX's
   indices) and the label-map functions on the card's outputs (exact).

Every path is driven with the launch counts set to 0 just before it and
read just after (rows 6 and 7 also counted by F).  The second-to-last
line is the kernels' JSON record, the last line ``{"ok": true, "device":
{...}}``.  Each kernel's record holds its bound: the larger of the bytes it
must move (each input read once, each output written once) over 3.35 TB/s
and the f32 operations it does on this run's inputs (counted per element as stated where the record is made, no
FMA) over 67 TFLOP/s, the H100 SXM data-sheet peaks at 700 W; and, where
one PyTorch call computes the same function, that call's time (row 8:
the sum of its two, the guarded ``donor[labels]`` and the ``index_add_`` of
the moments, each printed).
"""

import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(ROOT, 'tests', 'data', 'torch_port_fixture.npz')
FIXTURE_CONN = os.path.join(ROOT, 'tests', 'data',
                            'torch_port_fixture_conn.npz')
FIXTURE_FIT = os.path.join(ROOT, 'tests', 'data', 'torch_port_fixture_fit.npz')
FIXTURE_3D = os.path.join(ROOT, 'tests', 'data', 'torch_port_fixture_3d.npz')
FIXTURE_SUP = os.path.join(ROOT, 'tests', 'data',
                           'torch_port_fixture_sup.npz')
FIXTURE_CLF = os.path.join(ROOT, 'tests', 'data', 'torch_port_fixture_clf.npz')
FIXTURE_3D_TLM = os.path.join(ROOT, 'tests', 'data',
                              'torch_port_fixture_3d_tlm.npz')
FIXTURE_NOISE = os.path.join(ROOT, 'tests', 'data',
                             'torch_port_fixture_noise.npz')
FIXTURE_CENTERS = os.path.join(ROOT, 'tests', 'data',
                               'torch_port_fixture_centers.npz')
FIXTURE_RG2SP = os.path.join(ROOT, 'tests', 'data',
                             'torch_port_fixture_rg2sp.npz')
#: least share of enforced labels equal to JAX's on bench.py's noise images:
#: near-tie SLIC assignments flip between the port and XLA, and a moved
#: centroid of a fragmented superpixel moves its anchor
#: (tests/test_torch_noise.py); the SLIC and ARS bars are the scenes'
NOISE_ENFORCED_BAR = 0.997
CROP = (884, 1200)
SP_SIZE, SP_REGUL, GC_REGUL = 35, 0.2, 2.0
FEATURES = {'color': ['mean', 'std', 'energy']}
FEATURES_FIT = {'color': ['mean', 'std', 'energy', 'median', 'meanGrad']}
NB_CLASSES = 3
REPS = 20
DEVICE = 'cuda'
BATCH = 8
LIBRARIES = ('prep', 'slic', 'grid', 'enforce', 'slic3d', 'connectivity')
SHAPE_3D, SPACING_3D, SP_3D = (48, 640, 768), (4, 1, 1), 15
REGUL_3D, GC_REGUL_3D, NB_CLASSES_3D = 0.2, 0.1, 2
#: bars of the 3D path's standardised features against JAX's, on the
#: supervoxels whose voxel sets agree: mean and energy within rtol + atol,
#: std within an absolute bar (standardising its narrow column scales the
#: cancellation of sqrt(E[v^2] - E[v]^2) up); and the least share of
#: supervoxels whose voxel sets agree
FEAT_RTOL_3D, FEAT_ATOL_3D, STD_ATOL_3D, SAME_SETS_3D = 1e-5, 1e-5, 5e-3, 0.99
#: H100 SXM data-sheet peaks (700 W): device memory bytes/s, f32 FLOP/s
#: outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
#: f32 operations per candidate of a SLIC distance, no FMA: 2D colour
#: 3 sub + 3 mul + 2 add, spatial 2 sub + 2 mul + 1 add, weighting 2 mul +
#: 1 add, compare 1; 3D the same with one colour channel and three axes
#: (each axis sub + scale mul + square mul)
SLIC_OPS_2D, SLIC_OPS_3D = 17, 17
#: BASELINE config 2 (bench_all.py cfg2) and its reference-matching family
FEATURES_SUP = {'color': ['mean', 'std', 'energy'],
                'tGabor': ['mean', 'energy'], 'tLBP': ['mean']}
FEATURES_TLM = {'color': ['mean', 'std', 'energy'],
                'tLM': ['mean', 'std', 'energy']}
GC_REGUL_SUP = 5.0
#: the classifier families carried from the JAX package besides the forest
CLF_FAMILIES = ('GradBoost', 'AdaBoost', 'LogistRegr', 'SVM', 'KNN', 'MLP')
#: bar of config 2's proba with a carried family on the superpixels whose
#: pixel sets agree: features within rtol 1e-5 + 1e-4 move the linear
#: models' proba by up to ~1e-4, and a feature that close to a GBT
#: threshold or the k-th neighbour's distance moves a superpixel's by a
#: tree's step or a vote; so 1e-4, on all but PROBA_FAMILY_SHARE of them
PROBA_FAMILY_BAR, PROBA_FAMILY_SHARE = 1e-4, 0.005
#: the 3D path with LM texture: its features (the small fixture's)
FEATURES_3D_TLM = {'color': ['mean', 'std', 'energy'], 'tLM': ['mean']}
#: whole-slide tiles on the routes of rows 14 and 13 at sp_size 35
TILE_14, TILE_13 = (2048, 3600), (4096, 4096)
#: an odd geometry at sp_size 35: the width not a multiple of 4 (row 8's
#: scalar path) and the last tile row and column partial; and the seed moved
#: off the image's colours there, so that it wins no pixel
ODD, EMPTY_SEED = (883, 1197), (10, 10)
#: a shape whose last tile row and column are one pixel (at sp_size 35)
ONE_PX = (71, 106)


def _time_ms(fn, reps=REPS):
    """Mean device ms per call, CUDA events around ``reps`` warm calls."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _profiled(torch, fn, reps=5, tries=3):
    """(device ms, CUDA kernel launches) per call of ``fn``, from
    torch.profiler over ``reps`` warm calls: the durations of the device
    events (kernels and copies) summed, and the count of kernel events,
    each over ``reps``.  The profiler now and then drops events, so a
    profile that recorded no kernel, or a count of kernels that ``reps``
    calls cannot make (every wrapper launches a fixed number), is taken
    again; after ``tries`` profiles with no kernel the result is (nan,
    nan), not measured, and a fractional count stands as measured."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    out = float('nan'), float('nan')
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        device = [e for e in prof.events()
                  if str(e.device_type).endswith('CUDA')]
        kernels = [e for e in device
                   if not e.name.startswith(('Memcpy', 'Memset'))]
        if kernels:
            out = (sum(e.time_range.elapsed_us() for e in device) / 1e3
                   / reps, len(kernels) / reps)
            if len(kernels) % reps == 0:
                break
    return out


def _h2d_copies(torch, fn, reps=5):
    """Host-to-device copies per call of ``fn`` (torch.profiler's ``Memcpy
    HtoD`` events over ``reps`` warm calls)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if str(e.device_type).endswith('CUDA')
               and e.name.startswith('Memcpy HtoD')) / reps


def _final_pass(slic_cuda, lab_chw, centers, m, cfg, image):
    """Row 3 as the bench path runs it, the routed per-seed sums out: the
    final pass with the (H, W, 3) image and its route; with a package whose
    pass takes a zero-padded (3, pad_h, pad_w) copy of the image and returns
    partials only, that staging and ``combine_sums`` too."""
    import inspect
    import torch
    if 'feat' in inspect.signature(slic_cuda.slic_update_labels).parameters:
        return slic_cuda.slic_update_labels(lab_chw, centers, m, cfg,
                                            feat=image)[2]
    feat_chw = torch.zeros((3, cfg.pad_h, cfg.pad_w), dtype=torch.float32,
                           device=image.device)
    feat_chw[:, :cfg.height, :cfg.width] = image.permute(2, 0, 1)
    return slic_cuda.combine_sums(slic_cuda.slic_update_labels(
        lab_chw, centers, m, cfg, feat_chw)[1])


def measure_path_kernels(torch, img):
    """Rows 1, 2, 3, 4, 5, 8, 9, 10, 11, 12 and 15 as the paths call them
    (``ops.prep_cuda.blur_lab`` as ``_prepare_chw`` calls it, with its
    host-to-device copies per call; row 10 as
    ``ops.grid.counts_and_contacts`` on the enforced labels, the bench
    path's min-size measurement with its routing; row 11 as
    ``ops.grid.grid_adjacency`` on the enforced labels, as the edge weights
    call it, with its routing;
    ``ops.slic_cuda.slic_multi_update``, row 3 with its routing as
    ``_final_pass`` runs it, ``slic_assign`` plain and SLICO,
    ``slic_update``, ``ops.grid_cuda.grid_moments_apply`` with the min-size
    donor table, ``ops.grid.grid_lookup``, ``ops.enforce_cuda.enforce_fused``,
    and the whole SLIC stage of the bench path,
    ``slic_segment_with_features``) on image 0 and ``bench.py``'s first noise
    image (rows 8, 9 and 12 on the SLIC kernels' labels), and row 15's
    schedule and its two passes at the 3D workload: per call the call ms
    (CUDA events around REPS calls, as ``_time_ms``), the device ms and the
    CUDA kernel launches (``_profiled``); row 9 at C = 1 (the min-size
    merge's int32 donor table, and f32), 3 and 4, beside ``table[index]``;
    rows 6 (F = 7 f32 and bf16, F = 4 f32, F = 30 bf16) and 7 (F = 3, 18,
    60) on the SLIC labels of image 0 (``_reduce_rows``).
    Prints one ``path_kernels`` JSON line and returns its dict."""
    from pyimsegm_tpu_torch.ops import (enforce_cuda, grid_cuda, prep_cuda,
                                        slic3d, slic3d_cuda, slic_cuda)
    from pyimsegm_tpu_torch.ops import grid as grid_ops
    from pyimsegm_tpu_torch.ops import slic as slic_ops
    from pyimsegm_tpu_torch.utils.data_samples import sample_gray_volume_3d
    cfg = slic_ops.slic_config(CROP[0], CROP[1], SP_SIZE)
    m = slic_ops.compactness_from_regul(SP_SIZE, SP_REGUL)
    n_upd = slic_ops.DEFAULT_SLIC_ITERS - 1
    noise = torch.as_tensor(np.random.default_rng(0).random(
        CROP + (3,), dtype=np.float32), device=img.device)

    def timed(fn):
        return (_time_ms(fn), *_profiled(torch, fn))
    out = {}
    rng = np.random.default_rng(4)
    for name, image in (('image0', img), ('noise', noise)):
        labels, _, centers, _ = slic_ops.slic_segment_with_features(
            image, image, cfg, m)
        index = labels.long()
        row = {}
        lab_chw, centers0 = slic_ops._prepare_chw(image, cfg)
        for slico in (False, True):
            def schedule():
                return slic_cuda.slic_multi_update(lab_chw, centers0, m, cfg,
                                                   n_upd, slico=slico)
            row['slic_multi_update' + ('_slico' if slico else '')] = (
                _time_ms(schedule), *_profiled(torch, schedule))
        enf = grid_ops.enforce_grid_connectivity(labels, cfg,
                                                 centers=centers)
        row['blur_lab'] = timed(lambda: prep_cuda.blur_lab(image))
        row['blur_lab_h2d_copies'] = _h2d_copies(
            torch, lambda: prep_cuda.blur_lab(image))
        row['counts_and_contacts'] = timed(
            lambda: grid_ops.counts_and_contacts(enf, cfg))
        row['grid_adjacency'] = timed(
            lambda: grid_ops.grid_adjacency(enf, cfg))
        counts, sym25, counts9 = grid_ops.counts_and_contacts(enf, cfg)
        donor = grid_ops.donor_chain_table(
            counts, sym25, cfg.grid_h, cfg.grid_w,
            int(0.5 * cfg.step * cfg.step), counts9=counts9)

        def moments():
            return grid_cuda.grid_moments_apply(image, enf, donor, cfg)
        row['grid_moments_apply'] = (_time_ms(moments),
                                     *_profiled(torch, moments))
        tables = {
            'C1_int32': torch.arange(cfg.n_segments, dtype=torch.int32,
                                     device=img.device).flip(0),
            'C1_f32': torch.as_tensor(rng.random(cfg.n_segments, np.float32),
                                      device=img.device)}
        for c in (3, 4):
            tables['C%d_f32' % c] = torch.as_tensor(
                rng.random((cfg.n_segments, c), np.float32),
                device=img.device)
        for key, table in tables.items():
            row['lookup_' + key] = (
                _time_ms(lambda: grid_ops.grid_lookup(table, labels, cfg)),
                *_profiled(torch, lambda: grid_ops.grid_lookup(table, labels,
                                                               cfg)))
            row['index_' + key] = (_time_ms(lambda: table[index]),
                                   *_profiled(torch, lambda: table[index]))
        row['enforce_fused'] = (
            _time_ms(lambda: enforce_cuda.enforce_fused(labels, centers,
                                                        cfg)),
            *_profiled(torch, lambda: enforce_cuda.enforce_fused(
                labels, centers, cfg)))
        cen = slic_cuda.slic_multi_update(lab_chw, centers0, m, cfg, n_upd)
        cen_s = slic_cuda.slic_multi_update(lab_chw, centers0, m, cfg, n_upd,
                                            slico=True)
        row['slic_update_labels_routed'] = timed(
            lambda: _final_pass(slic_cuda, lab_chw, cen, m, cfg, image))
        row['slic_assign'] = timed(
            lambda: slic_cuda.slic_assign(lab_chw, cen, m, cfg))
        row['slic_assign_slico'] = timed(
            lambda: slic_cuda.slic_assign(lab_chw, cen_s, m, cfg, slico=True))
        row['slic_update'] = timed(
            lambda: slic_cuda.slic_update(lab_chw, cen, m, cfg))
        row['slic_stage'] = timed(
            lambda: slic_ops.slic_segment_with_features(image, image, cfg, m))
        if name == 'image0':
            row.update(_reduce_rows(torch, grid_cuda, labels, cfg, timed))
        out[name] = row
    cfg3 = slic3d.slic3d_config(SHAPE_3D, SP_3D, SPACING_3D)
    m3 = slic_ops.compactness_from_regul(SP_3D, REGUL_3D)
    vol_p, c0 = slic3d._prep3d(torch.as_tensor(
        sample_gray_volume_3d(SHAPE_3D)[0], device=img.device), cfg3)
    out['volume'] = {
        'slic3d_iterate': timed(lambda: slic3d_cuda.slic3d_iterate(
            vol_p, c0, m3, cfg3, slic_ops.DEFAULT_SLIC_ITERS)),
        'slic3d_labels': timed(lambda: slic3d_cuda.slic3d_labels(
            vol_p, c0, m3, cfg3)),
        'slic3d_partials': timed(lambda: slic3d_cuda.slic3d_partials(
            vol_p, c0, m3, cfg3))}
    print('path_kernels (call ms, device ms, kernel launches per call) %s'
          % json.dumps(out), flush=True)
    return out


def _reduce_rows(torch, grid_cuda, labels, cfg, timed):
    """Rows 6 (F = 7 f32 and bf16, and the paths' F = 4 f32 and 30 bf16)
    and 7 (F = 3, 18, 60) on ``labels``, each ``timed``, keyed by row and
    F."""
    rng = np.random.default_rng(3)
    out = {}
    for f, dtype in ((7, torch.float32), (7, torch.bfloat16),
                     (4, torch.float32), (30, torch.bfloat16)):
        data = torch.as_tensor(rng.normal(size=CROP + (f,)).astype(
            np.float32), device=labels.device).to(dtype)
        out['grid_reduce_f%d_%s' % (f, str(dtype).split('.')[-1])] = timed(
            lambda: grid_cuda.grid_reduce(data, labels, cfg))
    for f in (3, 18, 60):
        data = torch.as_tensor(rng.normal(size=CROP + (f,)).astype(
            np.float32), device=labels.device)
        out['grid_moments_f%d' % f] = timed(
            lambda: grid_cuda.grid_moments_apply(data, labels, None, cfg))
    return out


def _bf16_ulps(a, b):
    """Per-element distance in bf16 ulps of two bf16 tensors."""
    import torch

    def ordered(t):
        i = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return (ordered(a) - ordered(b)).abs()


def _bf16_agree(torch, got, want):
    """(share of equal values, largest distance in ulps) of two bf16
    tensors, a NaN equal to a NaN."""
    both = torch.isnan(got.float()) & torch.isnan(want.float())
    ulps = torch.where(both, 0, _bf16_ulps(got, want))
    return float((ulps == 0).float().mean()), int(ulps.max())


def _check_blur_lab(torch, prep_cuda, image, what):
    """Row 1 on ``image`` twice (equal bits) against its twin (>= 0.9999 of
    values equal, at most 1 ulp; NaN where the twin is NaN); returns (share
    equal, largest ulp, largest absolute difference of the finite values)."""
    out = prep_cuda.blur_lab(image)
    again = prep_cuda.blur_lab(image)
    want = prep_cuda._blur_lab_plain(image)
    torch.cuda.synchronize()
    equal, ulps = _bf16_agree(torch, out, want)
    same = torch.equal(out.view(torch.int16), again.view(torch.int16))
    diff = (out.float() - want.float()).abs()
    err = float(torch.where(torch.isnan(diff), 0.0, diff).max())
    print('blur_lab %s: bf16 equal %.6f, max %d ulp, max_abs_err %.3g, '
          'NaN %d / %d, two calls equal: %s'
          % (what, equal, ulps, err, int(torch.isnan(out.float()).sum()),
             int(torch.isnan(want.float()).sum()), same), flush=True)
    if equal < 0.9999 or ulps > 1 or not same:
        raise AssertionError('blur_lab %s: %.6f equal, max %d ulp, two calls '
                             'equal %s' % (what, equal, ulps, same))
    return equal, ulps, err


def _check_pair_count(torch, grid_cuda, labels, cfg, what):
    """Row 10 on ``labels``: (cnt9, counts9) and the routed triple, each
    twice with equal bits and exactly equal to the twins."""
    for name, kernel, plain in (
            ('grid_pair_count', grid_cuda.grid_pair_count,
             grid_cuda._grid_pair_count_plain),
            ('counts_and_contacts', grid_cuda.counts_and_contacts,
             grid_cuda._counts_and_contacts_plain)):
        out, again, want = kernel(labels, cfg), kernel(labels, cfg), \
            plain(labels, cfg)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) and torch.equal(a, c)
                   for a, b, c in zip(out, again, want)):
            raise AssertionError('%s %s: differs from its twin or between '
                                 'two calls' % (name, what))
    print('grid_pair_count %s: (cnt9, counts9) and the routed triple exact, '
          'two calls equal' % what, flush=True)


def _check_adjacency(torch, grid_cuda, labels, cfg, what):
    """Row 11 on ``labels``: the presence words alone, and the words and
    the routed adjacency of one call, each call twice with equal bits and
    exactly equal to the twins."""
    words_p = grid_cuda._grid_adjacency_presence_plain(labels, cfg)
    adj_p = grid_cuda._grid_adjacency_plain(labels, cfg)
    pairs = []
    for _ in range(2):
        words, adj = grid_cuda._adjacency_launch(labels, cfg, routed=True)
        pairs += [(grid_cuda.grid_adjacency_presence(labels, cfg), words_p),
                  (words, words_p), (adj, adj_p)]
    torch.cuda.synchronize()
    if not all(torch.equal(got, want) for got, want in pairs):
        raise AssertionError('grid_adjacency %s: differs from its twins or '
                             'between two calls' % what)
    print('grid_adjacency %s: words and routed adjacency exact, two calls '
          'equal (%d edges)' % (what, int(adj_p.sum())), flush=True)


def _bound(nbytes, ops):
    """(least ms, 'bytes' or 'operations'): the larger of the bytes over
    the memory rate and the f32 operations over the f32 peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def _record(name, source, replaces, err, kernel, plain_ms, agreement,
            nbytes, ops, library_ms=None, max_kernels=None):
    """A kernel's record: ``kernel`` is one call of its wrapper, timed as
    ``_time_ms`` times it (ms) and by ``_profiled`` (device ms, CUDA kernels
    per call; printed beside the rest).  With ``max_kernels`` a profile
    that counts more CUDA kernels per call fails (a profile that dropped
    events counts fewer)."""
    import torch
    ms = _time_ms(kernel)
    device_ms, per_call = _profiled(torch, kernel)
    if max_kernels is not None and per_call > max_kernels:
        raise AssertionError('%s: %g CUDA kernels per call, expected %d'
                             % (name, per_call, max_kernels))
    bound_ms, bound_by = _bound(nbytes, ops)
    print('kernel %-24s %s  max_abs_err %.3g  kernel %.4f ms  device %.4f '
          'ms in %g CUDA kernel(s)  plain %.4f ms  bound %.4f ms (%s)  '
          'library %s ms'
          % (name, agreement, err, ms, device_ms, per_call, plain_ms,
             bound_ms, bound_by,
             'none' if library_ms is None else '%.4f' % library_ms),
          flush=True)
    return {'name': name, 'route': 'cuda', 'source': source,
            'replaces': replaces, 'launches': 0, 'max_abs_err': err,
            'ms': ms, 'plain_ms': plain_ms, 'bound_ms': bound_ms,
            'bound_by': bound_by, 'library_ms': library_ms}


def kernel_phases(torch, img):
    """Each kernel against its plain twin at the bench geometry."""
    from pyimsegm_tpu_torch.ops import grid_cuda, prep_cuda, slic_cuda
    from pyimsegm_tpu_torch.ops import slic as slic_ops

    cfg = slic_ops.slic_config(CROP[0], CROP[1], SP_SIZE)
    m = slic_ops.compactness_from_regul(SP_SIZE, SP_REGUL)
    px, ppx, k = CROP[0] * CROP[1], cfg.pad_h * cfg.pad_w, cfg.n_segments
    records = []

    equal, ulps, err = _check_blur_lab(torch, prep_cuda, img, 'image 0')
    h2d = _h2d_copies(torch, lambda: prep_cuda.blur_lab(img))
    print('blur_lab: %g host-to-device copies per call' % h2d, flush=True)
    if h2d:
        raise AssertionError('blur_lab copies to the card in its call')
    records.append(_record(
        'blur_lab', 'pyimsegm_tpu_torch/csrc/prep.cu',
        'pyimsegm_tpu/ops/prep_pallas.py:121', err,
        lambda: prep_cuda.blur_lab(img),
        _time_ms(lambda: prep_cuda._blur_lab_plain(img)),
        'bf16 equal %.6f, max %d ulp' % (equal, ulps),
        # f32 RGB in, bf16 Lab out; per pixel 2 x 3 x 17 blur taps, 6 for
        # the rescale, ~57 for sRGB -> XYZ -> Lab
        px * (12 + 6), px * (102 + 6 + 57), max_kernels=2))

    lab_chw, centers0 = slic_ops._prepare_chw(img, cfg)
    n_upd = slic_ops.DEFAULT_SLIC_ITERS - 1
    cen_k = _one_schedule(lambda: slic_cuda.slic_multi_update(
        lab_chw, centers0, m, cfg, n_upd))
    cen_p = slic_cuda._slic_multi_update_plain(lab_chw, centers0, m, cfg,
                                               n_upd)
    torch.cuda.synchronize()
    err = float((cen_k - cen_p).abs().max())
    if not err <= 1e-3:
        raise AssertionError('slic_multi_update: centres differ by %g' % err)
    records.append(_record(
        'slic_multi_update', 'pyimsegm_tpu_torch/csrc/slic.cu',
        'pyimsegm_tpu/ops/slic_pallas.py:477', err,
        lambda: slic_cuda.slic_multi_update(lab_chw, centers0, m, cfg, n_upd),
        _time_ms(lambda: slic_cuda._slic_multi_update_plain(
            lab_chw, centers0, m, cfg, n_upd), reps=5),
        'centres within %.3g (tol 1e-3)' % err,
        # bf16 Lab in, centres in and out; per round and pixel 9 candidate
        # distances and 6 pooled sums
        ppx * 6 + 2 * k * 5 * 4, n_upd * ppx * (9 * SLIC_OPS_2D + 6)))

    lb_k, part_k, sums_k = slic_cuda.slic_update_labels(lab_chw, cen_k, m,
                                                        cfg, feat=img)
    lb_p, part_p, sums_p = slic_cuda._slic_update_labels_plain(
        lab_chw, cen_k, m, cfg, feat=img)
    torch.cuda.synchronize()
    lab_eq = float((lb_k == lb_p).float().mean())
    # partial sums are added in another order than the plain twin's: rtol
    # 1e-5, plus 1e-5 of the channel's largest partial for the signed Lab
    # a/b sums, whose relative error is unbounded where they cancel; the
    # routed sums are held to the same tolerance
    err = 0.0
    for got, want in ((part_k, part_p), (sums_k, sums_p)):
        diff = (got - want).abs()
        scale = want.abs().reshape(-1, want.shape[-1]).amax(dim=0)
        err = max(err, float(diff.max()))
        if lab_eq < 0.999 or not bool(
                (diff <= 1e-5 * want.abs() + 1e-5 * scale).all()):
            raise AssertionError('slic_update_labels: labels %.6f equal, '
                                 'partials / routed sums max diff %g'
                                 % (lab_eq, err))
    records.append(_record(
        'slic_update_labels', 'pyimsegm_tpu_torch/csrc/slic.cu',
        'pyimsegm_tpu/ops/slic_pallas.py:573', err,
        lambda: slic_cuda.slic_update_labels(lab_chw, cen_k, m, cfg,
                                             feat=img),
        _time_ms(lambda: slic_cuda._slic_update_labels_plain(
            lab_chw, cen_k, m, cfg, feat=img)),
        'labels equal %.6f, partials and routed sums within rtol 1e-5 '
        '(pass + route: at most 2 CUDA kernels per call)' % lab_eq,
        # bf16 Lab + f32 (H, W, 3) feature image in, i32 labels, partials
        # and routed sums out; per pixel 9 distances, 3 squares and 12
        # pooled sums, per seed and channel 9 routed adds
        ppx * (6 + 4) + px * 12 + k * 9 * 12 * 4 + k * 12 * 4,
        ppx * (9 * SLIC_OPS_2D + 3 + 12) + k * 12 * 9, max_kernels=2))

    labels = lb_k[:cfg.height, :cfg.width].contiguous()
    rng = np.random.default_rng(0)
    index = labels.long()
    # C = 1 int32 (the donor table: a seed id within the window, or an
    # out-of-grid id), 1 and 2 f32, 3 f32, 4 f32 (the batch's table), 5 f32
    # (the generic kernel), on labels with every fifth pixel set to a
    # negative, out-of-range or out-of-window id
    bad = labels.clone().reshape(-1)
    bad[::5] = torch.as_tensor(rng.choice(
        [-2, -1, k + 3, 0, k - 1], size=bad[::5].numel()).astype(np.int32),
        device=img.device)
    bad = bad.reshape(labels.shape)
    tables = [torch.as_tensor(rng.integers(-1, k + 2, k).astype(np.int32),
                              device=img.device)[:, None]]
    tables += [torch.as_tensor(rng.random((k, c), np.float32),
                               device=img.device) for c in (1, 2, 3, 4, 5)]
    for table in tables:
        for lab in (labels, bad):
            out_k = grid_cuda.grid_lookup(table, lab, cfg)
            out_p = grid_cuda._grid_lookup_plain(table, lab, cfg).to(
                table.dtype)
            torch.cuda.synchronize()
            if out_k.dtype != table.dtype or not torch.equal(out_k, out_p):
                raise AssertionError('grid_lookup C=%d %s: %d words differ'
                                     % (table.shape[1], table.dtype,
                                        int((out_k != out_p).sum())))
    table = tables[4]
    records.append(_record(
        'grid_lookup', 'pyimsegm_tpu_torch/csrc/grid.cu',
        'pyimsegm_tpu/ops/grid_pallas.py:379', 0.0,
        lambda: grid_cuda.grid_lookup(table, labels, cfg),
        _time_ms(lambda: grid_cuda._grid_lookup_plain(table, labels, cfg)),
        'exact at C = 1 (int32, f32), 2, 3, 4, 5, on the labels and on '
        'damaged labels (times: C = 4 f32)',
        # i32 labels + table in, (H, W, 4) f32 out; a window test per pixel
        px * (4 + 16) + k * 16, px * 6,
        _time_ms(lambda: table[index])))

    _check_adjacency(torch, grid_cuda, labels, cfg, 'SLIC labels of image 0')
    print('grid_adjacency_presence (the words) alone: %.4f ms, device %.4f '
          'ms in %g CUDA kernel(s)'
          % ((_time_ms(lambda: grid_cuda.grid_adjacency_presence(labels,
                                                                 cfg)),)
             + _profiled(torch, lambda: grid_cuda.grid_adjacency_presence(
                 labels, cfg))), flush=True)
    records.append(_record(
        'grid_adjacency_presence', 'pyimsegm_tpu_torch/csrc/grid.cu',
        'pyimsegm_tpu/ops/grid_pallas.py:568', 0.0,
        lambda: grid_cuda.grid_adjacency(labels, cfg),
        _time_ms(lambda: grid_cuda._grid_adjacency_plain(labels, cfg)),
        'exact: the words and the routed adjacency',
        # the routed call as the edge weights make it: i32 labels in,
        # (gh, gw, 25) f32 adjacency out (the (gh, gw, 9) words are scratch
        # the route reads back); two neighbour compares per pixel
        px * 4 + k * 25 * 4, px * 2, max_kernels=2))
    centers = (sums_k[..., 3:5] / torch.clamp_min(sums_k[..., 5:6], 1.0)) \
        .reshape(cfg.n_segments, 2)
    records += enforce_phases(torch, img, labels, centers, cfg)
    return records


#: enforcement cases beyond the bench geometry, as
#: tests/test_torch_enforce.py holds the twin against JAX on them: (image
#: kind, shape, sp_size) of fragmented noise labels and of a tall image
#: whose columns are longer than a block's stage (2,560 rows)
ENFORCE_CASES = {'noise': ('noise', (128, 160), 8),
                 'tall': ('scene', (2700, 48), 16)}


def enforce_cases(torch):
    """Row 12 against its twin (exact) on ENFORCE_CASES and on the
    serpentine labels that need more reach sweeps than the cap, with the
    sweeps and rounds each call ran."""
    from pyimsegm_tpu_torch.ops import connectivity_cuda as cc
    from pyimsegm_tpu_torch.ops import enforce_cuda
    from pyimsegm_tpu_torch.ops import grid as grid_ops
    from pyimsegm_tpu_torch.ops import slic as slic_ops
    from pyimsegm_tpu_torch.utils.data_samples import (
        sample_color_image_rand_segment, sample_serpentine_labels)
    cases = {}
    for name, (kind, shape, sp) in ENFORCE_CASES.items():
        img = (np.random.RandomState(7).rand(*shape, 3).astype(np.float32)
               if kind == 'noise' else
               sample_color_image_rand_segment(shape, 3, rand_seed=2)[0])
        img = torch.as_tensor(img, device=DEVICE)
        cfg = slic_ops.slic_config(*shape, sp)
        m = slic_ops.compactness_from_regul(sp, SP_REGUL)
        labels, _, centers, _ = slic_ops.slic_segment_with_features(
            img, img, cfg, m)
        cases[name] = (labels, centers, cfg)
    labels = torch.as_tensor(sample_serpentine_labels(), device=DEVICE)
    cfg = slic_ops.slic_config(labels.shape[0], labels.shape[1], 16)
    sums = grid_ops.grid_geometry_moments(
        torch.zeros(labels.shape + (1,), device=DEVICE), labels, cfg)
    cases['caps'] = (labels, sums[:, 3:5] / torch.clamp_min(sums[:, 2:3], 1.0),
                     cfg)
    for name, (labels, centers, cfg) in cases.items():
        out = enforce_cuda.enforce_fused(labels, centers, cfg)
        sweeps, rounds = cc.grid_passes(enforce_cuda.LAST_FLAGS, cfg)
        want = enforce_cuda._enforce_fused_plain(labels, centers, cfg)
        torch.cuda.synchronize()
        n_diff = int((out != want).sum())
        print('enforce_fused case %s %dx%d: %d pixels differ from the twin, '
              '%d relabelled, %d reach sweeps + %d absorb rounds'
              % (name, cfg.height, cfg.width, n_diff,
                 int((out != labels).sum()), sweeps, rounds), flush=True)
        if n_diff or (name == 'caps' and sweeps != cc.MAX_SWEEPS):
            raise AssertionError('enforce_fused disagrees on case %s' % name)


def _sums_agree(got, want):
    """rtol 1e-5 plus 1e-5 of the channel's largest sum: the sums are added
    in another order than the plain twin's.  Returns (ok, max abs diff)."""
    diff = (got - want).abs()
    scale = want.abs().amax(dim=0, keepdim=True)
    return (bool((diff <= 1e-5 * want.abs() + 1e-5 * scale).all()),
            float(diff.max()))


def _one_schedule(fn):
    """``fn()``, failing unless it made exactly one C call of row 2 (the
    wrapper's counters)."""
    from pyimsegm_tpu_torch.ops import slic_cuda
    keys = ('slic_multi_update', 'slic_multi_update_slico')
    before = sum(slic_cuda.LAUNCHES[k] for k in keys)
    out = fn()
    calls = sum(slic_cuda.LAUNCHES[k] for k in keys) - before
    if calls != 1:
        raise AssertionError('slic_multi_update: %d C calls for one '
                             'schedule' % calls)
    return out


def check_schedule(torch, lab_chw, centers0, m, cfg, where, empty=None,
                   n_upd=None):
    """Row 2, plain and SLICO, against its twin: centres within 1e-3, M
    within 1e-3 relative, one C call per schedule of ``n_upd`` rounds (the
    path's count by default); with ``empty`` that seed's cluster must stay
    empty and keep its centre (M = 1 after a round).  Returns the largest
    centre difference."""
    from pyimsegm_tpu_torch.ops import slic as slic_ops
    from pyimsegm_tpu_torch.ops import slic_cuda
    if n_upd is None:
        n_upd = slic_ops.DEFAULT_SLIC_ITERS - 1
    err = 0.0
    for slico in (False, True):
        got = _one_schedule(lambda: slic_cuda.slic_multi_update(
            lab_chw, centers0, m, cfg, n_upd, slico=slico))
        want = slic_cuda._slic_multi_update_plain(lab_chw, centers0, m, cfg,
                                                  n_upd, slico)
        torch.cuda.synchronize()
        e = float((got[..., :5] - want[..., :5]).abs().max())
        m_rel = (float(((got[..., 5] - want[..., 5]).abs()
                        / want[..., 5]).max()) if slico else 0.0)
        kept = empty is None or (
            torch.equal(got[empty][:5], centers0[empty])
            and (not slico or n_upd == 0 or float(got[empty][5]) == 1.0))
        print('slic_multi_update%s at %s, %d rounds: centres within %.3g, M '
              'within %.3g relative (tol 1e-3), one C call%s'
              % (' SLICO' if slico else '', where, n_upd, e, m_rel,
                 '' if empty is None else ', empty cluster %s kept its '
                 'centre: %s' % (empty, kept)), flush=True)
        if not (e <= 1e-3 and m_rel <= 1e-3 and kept):
            raise AssertionError('slic_multi_update%s disagrees at %s'
                                 % (' SLICO' if slico else '', where))
        err = max(err, e)
    return err


def odd_geometry_phases(torch):
    """Rows 2 and 8 against their twins at ODD: the schedule from seeds of
    which one wins no pixel, the donor apply + moments with the min-size
    and the window donor tables on the enforced SLIC kernels' labels."""
    from pyimsegm_tpu_torch.ops import grid as grid_ops
    from pyimsegm_tpu_torch.ops import grid_cuda
    from pyimsegm_tpu_torch.ops import slic as slic_ops
    from pyimsegm_tpu_torch.utils.data_samples import \
        sample_color_image_rand_segment
    img = torch.as_tensor(sample_color_image_rand_segment(
        ODD, 3, rand_seed=0)[0], device=DEVICE)
    cfg = slic_ops.slic_config(ODD[0], ODD[1], SP_SIZE)
    m = slic_ops.compactness_from_regul(SP_SIZE, SP_REGUL)
    lab_chw, centers0 = slic_ops._prepare_chw(img, cfg)
    centers0 = centers0.clone()
    centers0[EMPTY_SEED + (0,)] = 1000.0          # L far beyond the image's
    for n_upd in (0, 1, None):
        check_schedule(torch, lab_chw, centers0, m, cfg, '%dx%d' % ODD,
                       empty=EMPTY_SEED, n_upd=n_upd)
    labels, _, centers, _ = slic_ops.slic_segment_with_features(img, img,
                                                                cfg, m)
    enf = grid_ops.enforce_grid_connectivity(labels, cfg, centers=centers)
    counts, sym25, counts9 = grid_ops.counts_and_contacts(enf, cfg)
    donor = grid_ops.donor_chain_table(counts, sym25, cfg.grid_h, cfg.grid_w,
                                       int(0.5 * cfg.step * cfg.step),
                                       counts9=counts9)
    for name, table in (('chain', donor),
                        ('window', _window_donor(torch, cfg, DEVICE))):
        lab_k, sums_k = grid_cuda.grid_moments_apply(img, enf, table, cfg)
        lab_p, sums_p = grid_cuda._grid_moments_apply_plain(img, enf, table,
                                                            cfg)
        torch.cuda.synchronize()
        ok, diff = _sums_agree(sums_k, sums_p)
        n_diff = int((lab_k != lab_p).sum())
        print('grid_moments_apply at %dx%d, %s donors: %d px merged, %d '
              'labels differ from the twin, sums max diff %g (rtol 1e-5)'
              % (ODD[0], ODD[1], name, int((lab_k != enf).sum()), n_diff,
                 diff), flush=True)
        if n_diff or not ok:
            raise AssertionError('grid_moments_apply disagrees at %dx%d'
                                 % ODD)


def _window_donor(torch, cfg, device):
    """A donor table of random seeds within +-1 grid cell: most pixels merge,
    those whose tile lies further from the donor keep their label."""
    rng = np.random.default_rng(1)
    gy, gx = np.divmod(np.arange(cfg.n_segments), cfg.grid_w)
    ny = np.clip(gy + rng.integers(-1, 2, gy.size), 0, cfg.grid_h - 1)
    nx = np.clip(gx + rng.integers(-1, 2, gx.size), 0, cfg.grid_w - 1)
    return torch.as_tensor((ny * cfg.grid_w + nx).astype(np.int32),
                           device=device)


def enforce_phases(torch, img, labels, centers, cfg):
    """The three kernels of the enforcement and min-size merge (and the
    donor-less moments mode) against their twins at the bench geometry, on
    the SLIC kernels' labels and centroids of image 0 and, for the
    enforcement, also of the bench's noise fallback image, whose fragmented
    superpixels make the absorb do real work."""
    from pyimsegm_tpu_torch.ops import enforce_cuda, grid_cuda
    from pyimsegm_tpu_torch.ops import grid as grid_ops
    from pyimsegm_tpu_torch.ops import slic as slic_ops
    records = []

    noise = torch.as_tensor(np.random.default_rng(0).random(
        CROP + (3,), dtype=np.float32), device=img.device)
    m = slic_ops.compactness_from_regul(SP_SIZE, SP_REGUL)
    noise_labels, _, noise_centers, _ = slic_ops.slic_segment_with_features(
        noise, noise, cfg, m)
    notes, times = [], []
    for lab, cen in ((labels, centers), (noise_labels, noise_centers)):
        enf = enforce_cuda.enforce_fused(lab, cen, cfg)
        enf_p = enforce_cuda._enforce_fused_plain(lab, cen, cfg)
        torch.cuda.synchronize()
        n_diff = int((enf != enf_p).sum())
        if n_diff:
            raise AssertionError('enforce_fused: %d pixels differ' % n_diff)
        notes.append(float((enf != lab).float().mean()))
        times.append((
            _time_ms(lambda: enforce_cuda.enforce_fused(lab, cen, cfg)),
            _time_ms(lambda: enforce_cuda._enforce_fused_plain(lab, cen, cfg),
                     reps=5)))
    print('enforce_fused on the noise image: kernel %.4f ms, plain %.4f ms'
          % times[1], flush=True)
    enf = enforce_cuda.enforce_fused(labels, centers, cfg)
    px, k = CROP[0] * CROP[1], cfg.n_segments
    records.append(_record(
        'enforce_fused', 'pyimsegm_tpu_torch/csrc/enforce.cu',
        'pyimsegm_tpu/ops/enforce_pallas.py:297', 0.0,
        lambda: enforce_cuda.enforce_fused(labels, centers, cfg), times[0][1],
        'exact (%.6f / %.6f of pixels relabelled: image 0 / '
        'noise)' % tuple(notes),
        # i32 labels + centroids in, labels out; per pixel the anchor
        # distance (6) and one pass of 4 neighbour compares: what a single
        # connected-components sweep of image 0, with almost nothing to
        # relabel, needs
        px * 8 + k * 8, px * 10))

    flat = enf.reshape(-1).long()
    pair_codes = torch.cat([
        (enf[:, :-1].long() * k + enf[:, 1:].long()).reshape(-1),
        (enf[:-1].long() * k + enf[1:].long()).reshape(-1)])
    moment_data = torch.cat([img.reshape(-1, 3), (img * img).reshape(-1, 3),
                             torch.ones_like(img[..., :1]).reshape(-1, 1),
                             torch.stack(torch.meshgrid(
                                 *[torch.arange(n, dtype=torch.float32,
                                                device=img.device)
                                   for n in CROP], indexing='ij'),
                                 dim=-1).reshape(-1, 2)], dim=-1)
    noise_enf = enforce_cuda.enforce_fused(noise_labels, noise_centers, cfg)
    for lab, what in (
            (labels, 'SLIC labels of image 0'),
            (enf, 'enforced labels of image 0'),
            (_damaged_labels(torch, labels, cfg, 7),
             'damaged labels of image 0'),
            (noise_labels, 'SLIC labels of the noise image'),
            (noise_enf, 'enforced labels of the noise image'),
            (_damaged_labels(torch, noise_labels, cfg, 8),
             'damaged labels of the noise image')):
        _check_pair_count(torch, grid_cuda, lab, cfg, what)
        _check_adjacency(torch, grid_cuda, lab, cfg, what)
    print('grid_pair_count (cnt9, counts9) alone, enforced labels of image 0: '
          '%.4f ms, device %.4f ms in %g CUDA kernel(s), bound %.4f ms (%s)'
          % ((_time_ms(lambda: grid_cuda.grid_pair_count(enf, cfg)),)
             + _profiled(torch, lambda: grid_cuda.grid_pair_count(enf, cfg))
             + _bound(px * 4 + k * (225 + 9) * 4, px * 3)), flush=True)
    records.append(_record(
        'grid_pair_count', 'pyimsegm_tpu_torch/csrc/grid.cu',
        'pyimsegm_tpu/ops/grid_pallas.py:478', 0.0,
        lambda: grid_cuda.counts_and_contacts(enf, cfg),
        _time_ms(lambda: grid_cuda._counts_and_contacts_plain(enf, cfg)),
        'exact: (cnt9, counts9) and the routed triple',
        # the routed call as the min-size merge makes it: i32 labels in,
        # (K,) counts + (gh, gw, 25) contacts + (gh, gw, 9) counts f32 out
        # (the (gh, gw, 9, 25) pair counts are scratch the route reads
        # back); two pair compares and a count per pixel
        px * 4 + k * (1 + 25 + 9) * 4, px * 3,
        _time_ms(lambda: torch.bincount(pair_codes, minlength=k * k)),
        max_kernels=2))

    min_size = int(0.5 * cfg.step * cfg.step)
    counts, sym25, counts9 = grid_ops.counts_and_contacts(enf, cfg)
    donor = grid_ops.donor_chain_table(counts, sym25, cfg.grid_h, cfg.grid_w,
                                       min_size, counts9=counts9)
    merges = []
    err = 0.0
    merged = grid_cuda.grid_moments_apply(img, enf, donor, cfg)[0]
    for table in (donor, _window_donor(torch, cfg, img.device)):
        lab_k, sums_k = grid_cuda.grid_moments_apply(img, enf, table, cfg)
        lab_p, sums_p = grid_cuda._grid_moments_apply_plain(img, enf, table,
                                                            cfg)
        torch.cuda.synchronize()
        ok, diff = _sums_agree(sums_k, sums_p)
        if not torch.equal(lab_k, lab_p) or not ok:
            raise AssertionError('grid_moments_apply: %d labels differ, sums '
                                 'max diff %g' % (int((lab_k != lab_p).sum()),
                                                  diff))
        merges.append(int((lab_k != enf).sum()))
        err = max(err, diff)
    # the library yardstick: donor[labels] with the window guard, then the
    # index_add_ of the moments over the merged labels
    index, donor64 = enf.long(), donor.long()
    ty = torch.arange(CROP[0], device=img.device)[:, None] // cfg.step
    tx = torch.arange(CROP[1], device=img.device)[None, :] // cfg.step

    def guarded_donor():
        new = donor64[index]
        ok = (new >= 0) & ((new // cfg.grid_w - ty).abs() <= 1) \
            & ((new % cfg.grid_w - tx).abs() <= 1)
        return torch.where(ok, new, index)

    merged_flat = merged.reshape(-1).long()
    library = (_time_ms(guarded_donor),
               _time_ms(lambda: torch.zeros((k, 9), device=img.device)
                        .index_add_(0, merged_flat, moment_data)))
    print('grid_moments_apply library yardstick: donor[labels] with the '
          'window guard %.4f ms + index_add_ of the moments %.4f ms'
          % library, flush=True)
    records.append(_record(
        'grid_moments_apply', 'pyimsegm_tpu_torch/csrc/grid.cu',
        'pyimsegm_tpu/ops/grid_pallas.py:302', err,
        lambda: grid_cuda.grid_moments_apply(img, enf, donor, cfg),
        _time_ms(lambda: grid_cuda._grid_moments_apply_plain(img, enf, donor,
                                                             cfg)),
        'labels exact (%d / %d px merged: chain / window donors), sums '
        'within rtol 1e-5' % tuple(merges),
        # f32 RGB + i32 labels + i64 donor table in, labels + (K, 9) sums
        # out; per pixel a donor lookup, 3 squares and 9 sums
        px * (12 + 4 + 4) + k * 8 + k * 9 * 4, px * (1 + 3 + 9),
        sum(library)))

    sums_k = grid_cuda.grid_moments_apply(img, enf, None, cfg)[1]
    sums_p = grid_cuda._grid_moments_apply_plain(img, enf, None, cfg)[1]
    torch.cuda.synchronize()
    ok, err = _sums_agree(sums_k, sums_p)
    if not ok:
        raise AssertionError('grid_moments: sums max diff %g' % err)
    records.append(_record(
        'grid_moments', 'pyimsegm_tpu_torch/csrc/grid.cu',
        'pyimsegm_tpu/ops/grid_pallas.py:195', err,
        lambda: grid_cuda.grid_moments_apply(img, enf, None, cfg),
        _time_ms(lambda: grid_cuda._grid_moments_apply_plain(img, enf, None,
                                                             cfg)),
        'sums within rtol 1e-5',
        # f32 RGB + i32 labels in, (K, 9) sums out; 3 squares and 9 sums
        # per pixel
        px * (12 + 4) + k * 9 * 4, px * (3 + 9),
        _time_ms(lambda: torch.zeros((k, 9), device=img.device).index_add_(
            0, flat, moment_data)), max_kernels=2))
    return records


def fit_kernel_phases(torch, img):
    """The fit path's kernels against their twins at the bench geometry:
    the labels-only and partials-only assignment passes, the SLICO mode of
    the multi-update and assignment, and the grid reduce."""
    from pyimsegm_tpu_torch.ops import grid_cuda, slic_cuda
    from pyimsegm_tpu_torch.ops import slic as slic_ops
    cfg = slic_ops.slic_config(CROP[0], CROP[1], SP_SIZE)
    m = slic_ops.compactness_from_regul(SP_SIZE, SP_REGUL)
    n_upd = slic_ops.DEFAULT_SLIC_ITERS - 1
    lab_chw, centers0 = slic_ops._prepare_chw(img, cfg)
    cen = slic_cuda.slic_multi_update(lab_chw, centers0, m, cfg, n_upd)
    px, ppx, k = CROP[0] * CROP[1], cfg.pad_h * cfg.pad_w, cfg.n_segments
    records = []

    for slico in (False, True):
        name = 'slic_assign_slico' if slico else 'slic_assign'
        c = cen
        if slico:
            c = _one_schedule(lambda: slic_cuda.slic_multi_update(
                lab_chw, centers0, m, cfg, n_upd, slico=True))
            c_p = slic_cuda._slic_multi_update_plain(lab_chw, centers0, m,
                                                     cfg, n_upd, slico=True)
            torch.cuda.synchronize()
            err = float((c[..., :5] - c_p[..., :5]).abs().max())
            m_rel = float(((c[..., 5] - c_p[..., 5]).abs()
                           / c_p[..., 5]).max())
            if not (err <= 1e-3 and m_rel <= 1e-3):
                raise AssertionError('slic_multi_update SLICO: centres differ '
                                     'by %g, M by %g relative' % (err, m_rel))
            records.append(_record(
                'slic_multi_update_slico', 'pyimsegm_tpu_torch/csrc/slic.cu',
                'pyimsegm_tpu/ops/slic_pallas.py:477', err,
                lambda: slic_cuda.slic_multi_update(
                    lab_chw, centers0, m, cfg, n_upd, slico=True),
                _time_ms(lambda: slic_cuda._slic_multi_update_plain(
                    lab_chw, centers0, m, cfg, n_upd, slico=True), reps=5),
                'centres within %.3g, M within %.3g relative (tol 1e-3)'
                % (err, m_rel),
                # as the plain multi-update, plus a max per pixel
                ppx * 6 + 2 * k * 6 * 4,
                n_upd * ppx * (9 * SLIC_OPS_2D + 7)))
        lb_k = slic_cuda.slic_assign(lab_chw, c, m, cfg, slico=slico)
        lb_p = slic_cuda._slic_assign_plain(lab_chw, c, m, cfg, slico=slico)
        torch.cuda.synchronize()
        if not torch.equal(lb_k, lb_p):
            raise AssertionError('%s: %d labels differ'
                                 % (name, int((lb_k != lb_p).sum())))
        records.append(_record(
            name, 'pyimsegm_tpu_torch/csrc/slic.cu',
            'pyimsegm_tpu/ops/slic_pallas.py:619', 0.0,
            lambda: slic_cuda.slic_assign(lab_chw, c, m, cfg, slico=slico),
            _time_ms(lambda: slic_cuda._slic_assign_plain(lab_chw, c, m, cfg,
                                                          slico=slico)),
            'labels exact',
            # bf16 Lab in, i32 labels out; 9 distances per pixel
            ppx * (6 + 4) + k * 6 * 4, ppx * 9 * SLIC_OPS_2D))

    part_k = slic_cuda.slic_update(lab_chw, cen, m, cfg)
    part_p = slic_cuda._slic_update_plain(lab_chw, cen, m, cfg)
    torch.cuda.synchronize()
    diff = (part_k - part_p).abs()
    scale = part_p.abs().amax(dim=(0, 1, 2), keepdim=True)
    err = float(diff.max())
    if not bool((diff <= 1e-5 * part_p.abs() + 1e-5 * scale).all()):
        raise AssertionError('slic_update: partials max diff %g' % err)
    records.append(_record(
        'slic_update', 'pyimsegm_tpu_torch/csrc/slic.cu',
        'pyimsegm_tpu/ops/slic_pallas.py:604', err,
        lambda: slic_cuda.slic_update(lab_chw, cen, m, cfg),
        _time_ms(lambda: slic_cuda._slic_update_plain(lab_chw, cen, m, cfg)),
        'partials within rtol 1e-5',
        # bf16 Lab in, (gh, gw, 9, 6) partials out; 9 distances and 6
        # pooled sums per pixel
        ppx * 6 + k * 54 * 4, ppx * (9 * SLIC_OPS_2D + 6)))

    labels = slic_cuda.slic_assign(lab_chw, cen, m, cfg)[:cfg.height,
                                                         :cfg.width]
    labels = labels.contiguous()
    flat = labels.reshape(-1).long()
    rng = np.random.default_rng(2)
    err, times = 0.0, {}
    for f in (3, 4, 7, 15, 30, 40):
        data = torch.as_tensor(rng.normal(size=CROP + (f,)).astype(
            np.float32), device=img.device)
        for dtype in (torch.float32, torch.bfloat16):
            d = data.to(dtype)
            got = grid_cuda.grid_reduce(d, labels, cfg)
            want = grid_cuda._grid_reduce_plain(d, labels, cfg)
            torch.cuda.synchronize()
            ok, diff = _sums_agree(got, want)
            if not ok:
                raise AssertionError('grid_reduce F=%d %s: max diff %g'
                                     % (f, dtype, diff))
            err = max(err, diff)
            if (f, dtype) == (7, torch.float32):
                data7_f = d
            times[(f, dtype)] = (
                _time_ms(lambda: grid_cuda.grid_reduce(d, labels, cfg)),
                _time_ms(lambda: grid_cuda._grid_reduce_plain(d, labels,
                                                              cfg)))
    print('grid_reduce kernel / plain ms: %s' % ', '.join(
        'F=%d %s %.4f / %.4f' % (f, str(dt).split('.')[-1], *times[(f, dt)])
        for f, dt in times), flush=True)
    data7 = torch.as_tensor(rng.normal(size=(px, 7)).astype(np.float32),
                            device=img.device)
    records.append(_record(
        'grid_reduce', 'pyimsegm_tpu_torch/csrc/grid.cu',
        'pyimsegm_tpu/ops/grid_pallas.py:106', err,
        lambda: grid_cuda.grid_reduce(data7_f, labels, cfg),
        times[(7, torch.float32)][1],
        'sums within rtol 1e-5 at F = 3, 4, 7, 15, 30, 40, f32 and bf16 '
        '(times: F=7 f32)',
        # F = 7 f32 data + i32 labels in, (K, 7) sums out; 7 adds per pixel
        px * (28 + 4) + k * 28, px * 7,
        _time_ms(lambda: torch.zeros((k, 7), device=img.device).index_add_(
            0, flat, data7)), max_kernels=2))
    return records


#: row 15 beyond the 3D workload: at its spacing and sp_size a volume of 50
#: tiles (under one wave of co-resident blocks), and one whose shape is no
#: multiple of the steps (4, 15, 15), from seeds of which one (v = 1e6) wins
#: no voxel, so that its cluster stays empty and keeps its centre; and at
#: sp_size 30, spacing (1, 1, 1), tiles of 30 x 30 rows of 30 voxels, more
#: rows than a block has threads: (shape, sp_size, spacing, empty seed)
CASES_3D = {'one wave': ((8, 64, 66), SP_3D, SPACING_3D, None),
            'odd': ((46, 200, 234), SP_3D, SPACING_3D, (1, 3, 4)),
            'chunked': ((40, 90, 96), 30, (1, 1, 1), None)}


def _check_passes_3d(torch, vol_p, centers, m, cfg, where):
    """Row 15's labels pass (exact) and partials pass (rtol 1e-5 plus 1e-5
    of the channel's largest partial) against their twins on the same
    centres; returns (largest label id difference, partials max diff)."""
    from pyimsegm_tpu_torch.ops import slic3d_cuda
    lb_k = slic3d_cuda.slic3d_labels(vol_p, centers, m, cfg)
    lb_p = slic3d_cuda._slic3d_labels_plain(vol_p, centers, m, cfg)
    part_k = slic3d_cuda.slic3d_partials(vol_p, centers, m, cfg)
    part_p = slic3d_cuda._slic3d_partials_plain(vol_p, centers, m, cfg)
    torch.cuda.synchronize()
    if not torch.equal(lb_k, lb_p):
        raise AssertionError('slic3d_labels at %s: %d labels differ'
                             % (where, int((lb_k != lb_p).sum())))
    diff = (part_k - part_p).abs()
    scale = part_p.abs().amax(dim=(0, 1, 2, 3), keepdim=True)
    if not bool((diff <= 1e-5 * part_p.abs() + 1e-5 * scale).all()):
        raise AssertionError('slic3d_partials at %s: max diff %g'
                             % (where, float(diff.max())))
    return float((lb_k - lb_p).abs().max()), float(diff.max())


def _iterate_vs_twin(torch, vp, cc, m, cfg, n_iter):
    """(kernel labels, twin labels) of the whole schedule; the schedule run
    twice must give the same labels."""
    from pyimsegm_tpu_torch.ops import slic3d_cuda
    lk = slic3d_cuda.slic3d_iterate(vp, cc, m, cfg, n_iter)
    again = slic3d_cuda.slic3d_iterate(vp, cc, m, cfg, n_iter)
    lp = slic3d_cuda._slic3d_iterate_plain(vp, cc, m, cfg, n_iter)
    torch.cuda.synchronize()
    if not torch.equal(lk, again):
        raise AssertionError('slic3d_iterate: two runs differ in %d voxels'
                             % int((lk != again).sum()))
    return lk, lp


def kernel_phases_3d(torch, vol, noise):
    """Row 15's two passes against their twins on the same centres (the
    seeds, and the centres after one round), and the whole schedule against
    its twin on the structured and the noise volume, at the 3D workload;
    the passes and the schedule also on CASES_3D."""
    from pyimsegm_tpu_torch.ops import graph, slic3d, slic3d_cuda
    from pyimsegm_tpu_torch.ops.slic import compactness_from_regul
    from pyimsegm_tpu_torch.utils.data_samples import sample_gray_volume_3d
    cfg = slic3d.slic3d_config(SHAPE_3D, SP_3D, SPACING_3D)
    m = compactness_from_regul(SP_3D, REGUL_3D)
    vol_p, c0 = slic3d._prep3d(vol, cfg)
    c1 = slic3d_cuda._update3d_plain(
        slic3d_cuda.slic3d_partials(vol_p, c0, m, cfg), c0)
    records = []
    n_vox, pvox, k = int(np.prod(SHAPE_3D)), int(np.prod(cfg.pad)), \
        cfg.n_segments
    n_iter = 10
    err, err_lb = 0.0, 0.0
    for cen in (c0, c1):
        e_lb, e = _check_passes_3d(torch, vol_p, cen, m, cfg, '%dx%dx%d'
                                   % SHAPE_3D)
        err_lb, err = max(err_lb, e_lb), max(err, e)
    for name, (shape, sp, spacing, empty) in CASES_3D.items():
        c = slic3d.slic3d_config(shape, sp, spacing)
        m_c = compactness_from_regul(sp, REGUL_3D)
        vp, cc = slic3d._prep3d(torch.as_tensor(
            sample_gray_volume_3d(shape, rand_seed=2)[0], device=DEVICE), c)
        if empty is not None:
            cc = cc.clone()
            cc[empty + (0,)] = 1e6                # v far beyond the volume's
        where = '%s %dx%dx%d (steps %s, %d tiles)' % (
            (name,) + shape + (c.steps, c.n_segments))
        e_lb, e = _check_passes_3d(torch, vp, cc, m_c, c, where)
        err_lb, err = max(err_lb, e_lb), max(err, e)
        lk, lp = _iterate_vs_twin(torch, vp, cc, m_c, c, n_iter)
        eq = float((lk == lp).float().mean())
        kept = True
        if empty is not None:
            eid = (empty[0] * c.grid[1] + empty[1]) * c.grid[2] + empty[2]
            kept = not bool((lk == eid).any()) and not bool((lp == eid).any())
        print('slic3d at %s: passes exact / within rtol 1e-5, schedule labels '
              'equal %.6f (>= 0.999, %d voxels differ), two runs equal%s'
              % (where, eq, int((lk != lp).sum()),
                 '' if empty is None else ', empty cluster %s kept empty: %s'
                 % (empty, kept)), flush=True)
        if eq < 0.999 or not kept:
            raise AssertionError('slic3d_iterate disagrees at %s' % where)
    records.append(_record(
        'slic3d_labels', 'pyimsegm_tpu_torch/csrc/slic3d.cu',
        'pyimsegm_tpu/ops/slic3d_pallas.py:183', err_lb,
        lambda: slic3d_cuda.slic3d_labels(vol_p, c1, m, cfg),
        _time_ms(lambda: slic3d_cuda._slic3d_labels_plain(vol_p, c1, m, cfg),
                 reps=3),
        'labels exact (seeds and centres after one round; on CASES_3D '
        'too)',
        # f32 padded volume in, i32 labels out; 27 distances per voxel
        pvox * (4 + 4) + k * 16, pvox * 27 * SLIC_OPS_3D, max_kernels=1))
    records.append(_record(
        'slic3d_partials', 'pyimsegm_tpu_torch/csrc/slic3d.cu',
        'pyimsegm_tpu/ops/slic3d_pallas.py:183', err,
        lambda: slic3d_cuda.slic3d_partials(vol_p, c1, m, cfg),
        _time_ms(lambda: slic3d_cuda._slic3d_partials_plain(vol_p, c1, m,
                                                            cfg), reps=3),
        'partials within rtol 1e-5 + 1e-5 x channel max',
        # f32 padded volume in, (K, 27, 5) partials out; 27 distances per
        # voxel and 5 pooled sums per valid voxel
        pvox * 4 + k * 16 + k * 135 * 4,
        pvox * 27 * SLIC_OPS_3D + n_vox * 5, max_kernels=1))

    agree, n_diff = {}, {}
    err = 0.0
    z, h, w = SHAPE_3D
    for name, v in (('structured', vol), ('noise', noise)):
        vp, cc = slic3d._prep3d(v, cfg)
        lk, lp = _iterate_vs_twin(torch, vp, cc, m, cfg, n_iter)
        agree[name] = float((lk == lp).float().mean())
        n_diff[name] = int((lk != lp).sum())
        # the largest difference of two label ids, over both volumes
        err = max(err, float((lk - lp).abs().max()))
        print('%s volume: edges %s' % (name, json.dumps(
            graph.adjacency3d_counts(lk[:z, :h, :w], cfg))), flush=True)
    print('slic3d_iterate vs twin, labels equal: structured %.6f (%d voxels '
          'differ; >= 0.999), noise %.6f (%d voxels differ; reported), '
          'largest label id difference %d; two runs of each equal'
          % (agree['structured'], n_diff['structured'], agree['noise'],
             n_diff['noise'], err), flush=True)
    if agree['structured'] < 0.999:
        raise AssertionError('slic3d_iterate disagrees with its twin')
    records.append(_record(
        'slic3d_iterate', 'pyimsegm_tpu_torch/csrc/slic3d.cu',
        'pyimsegm_tpu/ops/slic3d_pallas.py:183', err,
        lambda: slic3d_cuda.slic3d_iterate(vol_p, c0, m, cfg, n_iter),
        _time_ms(lambda: slic3d_cuda._slic3d_iterate_plain(vol_p, c0, m, cfg,
                                                           n_iter), reps=1),
        'labels equal %.6f (structured) / %.6f (noise), %d / %d voxels '
        'differ; one CUDA kernel per schedule'
        % (agree['structured'], agree['noise'], n_diff['structured'],
           n_diff['noise']),
        # f32 padded volume + seeds in, i32 labels out; 9 partials passes,
        # 9 updates (27 x 5 adds + 4 divisions per seed) and a labels pass
        pvox * (4 + 4) + k * 16,
        n_iter * pvox * 27 * SLIC_OPS_3D + (n_iter - 1) * (
            n_vox * 5 + k * (135 + 4)), max_kernels=1))
    return records


def path_gray3d(torch, vol, fixture):
    """The 3D gray-volume pipe at the repo's 3D workload, against the
    stored JAX result; returns the launch counts."""
    from pyimsegm_tpu_torch import pipelines
    from pyimsegm_tpu_torch.models import gmm
    from pyimsegm_tpu_torch.models.class_model import class_model_from_numpy
    from pyimsegm_tpu_torch.ops import graph, slic3d
    from pyimsegm_tpu_torch.utils.metrics import (adjusted_rand_score,
                                                  segment_digest)
    features = {'color': ['mean', 'std', 'energy']}

    def run(debug=None):
        return pipelines.pipe_gray3d_slic_features_model_graphcut(
            vol, NB_CLASSES_3D, features, spacing=SPACING_3D, sp_size=SP_3D,
            sp_regul=REGUL_3D, gc_regul=GC_REGUL_3D, debug_visual=debug)

    debug = {}
    segm, launches = _drive('3D path', PATH_3D, lambda: run(debug),
                            forbidden=PASSES_3D)
    if launches['slic3d_iterate'] != 1:
        raise AssertionError('3D path: %d SLIC schedules for one volume'
                             % launches['slic3d_iterate'])
    if segm.shape != SHAPE_3D or segm.min() < 0 \
            or segm.max() >= NB_CLASSES_3D:
        raise AssertionError('3D path: bad segmentation %s [%d, %d]'
                             % (segm.shape, segm.min(), segm.max()))
    want = np.unpackbits(fixture['segm_bits'])[:segm.size].reshape(SHAPE_3D)
    ars = adjusted_rand_score(segm, want)
    slic_eq = float((debug['slic'][fixture['slices']]
                     == fixture['slic']).mean())
    # features of the supervoxels whose voxel sets JAX's labelling has too
    digest = segment_digest(debug['slic'], fixture['features'].shape[0])
    same = np.all(digest == fixture['digest'], axis=1)
    held = same & (fixture['mask'] > 0)
    fd = np.abs(debug['features'] - fixture['features'])[held]
    rel = fd / np.maximum(np.abs(fixture['features'][held]), 1e-30)
    feat_ok = (bool((fd[:, 0::2] <= FEAT_RTOL_3D * np.abs(
        fixture['features'][held][:, 0::2]) + FEAT_ATOL_3D).all())
        and bool((fd[:, 1] <= STD_ATOL_3D).all()))
    jax_model = class_model_from_numpy({k: fixture[k] for k in (
        'weights', 'means', 'covs', 'scaler_mean', 'scaler_scale')}).to(DEVICE)
    model = debug['model']

    def ll_rel(x, w):
        """(card fit's weighted mean log-likelihood of x, the JAX fit's,
        their relative difference)"""
        x = torch.as_tensor(x, device=DEVICE)
        w = torch.as_tensor(w, dtype=torch.float32, device=DEVICE)
        ll_p = float(gmm.gmm_score(model.gmm, model.transform(x), w))
        ll_j = float(gmm.gmm_score(jax_model.gmm, jax_model.transform(x), w))
        return ll_p, ll_j, abs(ll_p - ll_j) / abs(ll_j)

    ll_jaxf = ll_rel(fixture['features'], fixture['mask'])
    ll_own = ll_rel(debug['features'], digest[:, 0] > 0)
    cfg = slic3d.slic3d_config(SHAPE_3D, SP_3D, SPACING_3D)
    counts = graph.adjacency3d_counts(
        torch.as_tensor(debug['slic'], device=DEVICE), cfg)
    print('3D path vs JAX-CPU: SLIC labels of z-slices %s equal %.6f '
          '(>= 0.999), segm ARS %.6f (>= 0.98); supervoxels with the same '
          'voxel set %d / %d (share >= %g); on the %d non-empty ones, '
          'standardised features '
          'max abs diff per column (mean, std, energy) %s, max rel diff %s '
          '(mean, energy <= %g x |value| + %g; std <= %g); weighted mean '
          'log-likelihood, card fit vs JAX fit, on the JAX features %.6f vs '
          '%.6f (rel %.3g) and on the card features %.6f vs %.6f (rel %.3g) '
          '(<= 1e-3); edges %d of the 8K capacity %d, edges 3 cells apart %d'
          % (fixture['slices'].tolist(), slic_eq, ars, int(same.sum()),
             same.size, SAME_SETS_3D, int(held.sum()),
             ['%.3g' % d for d in fd.max(axis=0)],
             ['%.3g' % d for d in rel.max(axis=0)], FEAT_RTOL_3D,
             FEAT_ATOL_3D, STD_ATOL_3D, *ll_jaxf, *ll_own,
             counts['edges'], counts['capacity'], counts['far_edges']),
          flush=True)
    if (slic_eq < 0.999 or ars < 0.98 or not feat_ok
            or same.mean() < SAME_SETS_3D or not ll_jaxf[2] <= 1e-3
            or not ll_own[2] <= 1e-3):
        raise AssertionError('3D path disagrees with the JAX reference')
    ms = [_warm_ms(torch, run, 1) for _ in range(3)]
    mvox = float(np.prod(SHAPE_3D)) / 1e6
    print('3D path warm ms per 48x640x768 volume: %s (best %.3f ms, %.3f '
          'MVox/s)' % (['%.3f' % t for t in ms], min(ms),
                       mvox / min(ms) * 1e3), flush=True)
    return launches


def _tables():
    from pyimsegm_tpu_torch.ops import (connectivity_cuda, enforce_cuda,
                                        grid_cuda, slic3d_cuda, slic_cuda)
    return (slic_cuda.LAUNCHES, grid_cuda.LAUNCHES, enforce_cuda.LAUNCHES,
            slic3d_cuda.LAUNCHES, connectivity_cuda.LAUNCHES)


def _counters():
    from pyimsegm_tpu_torch.ops import prep_cuda
    counts = {'blur_lab': prep_cuda.LAUNCHES}
    for table in _tables():
        counts.update(table)
    return counts


def _reset_counters():
    from pyimsegm_tpu_torch.ops import grid_cuda, prep_cuda
    prep_cuda.LAUNCHES = 0
    grid_cuda.LAUNCHES_BY_F.clear()
    for counts in _tables():
        for key in counts:
            counts[key] = 0


#: kernels each driven path must launch
PATH_FALSE = ('blur_lab', 'slic_multi_update', 'slic_update_labels',
              'grid_lookup', 'grid_adjacency_presence')
PATH_BENCH = PATH_FALSE + ('grid_pair_count', 'grid_moments_apply',
                           'enforce_fused')
PATH_OP = ('enforce_fused', 'grid_moments', 'grid_pair_count', 'grid_lookup')
PATH_FIT = ('blur_lab', 'slic_multi_update', 'slic_assign',
            'enforce_fused', 'grid_moments', 'grid_pair_count', 'grid_reduce',
            'grid_lookup', 'grid_adjacency_presence',
            'slic_multi_update_slico', 'slic_assign_slico')
#: the 3D pipe runs one schedule a volume; the standalone passes, the same
#: kernel, are held against their twins in kernel_phases_3d
PATH_3D = ('slic3d_iterate',)
PASSES_3D = ('slic3d_labels', 'slic3d_partials')


def _drive(name, kernels, fn, forbidden=()):
    """Run ``fn`` with every launch count set to 0 just before it; fail
    unless each of ``kernels`` launched and none of ``forbidden`` did.
    Returns (fn's result, counts)."""
    import torch
    from pyimsegm_tpu_torch.ops import grid_cuda
    torch.cuda.synchronize()
    _reset_counters()
    out = fn()
    launches = _counters()
    by_f = dict(grid_cuda.LAUNCHES_BY_F)
    missing = [k for k in kernels if launches[k] <= 0]
    if missing:
        raise AssertionError('%s: kernels not launched: %s' % (name, missing))
    extra = [k for k in forbidden if launches[k] > 0]
    if extra:
        raise AssertionError('%s: kernels of another route launched: %s'
                             % (name, extra))
    print('%s launches: %s' % (name, json.dumps(
        {k: launches[k] for k in kernels})), flush=True)
    if by_f:
        print('%s rows 6 / 7 launches by F: %s' % (name, json.dumps(by_f)),
              flush=True)
    return out, launches


def _check_outputs(segm, soft):
    if segm.shape != CROP or soft.shape != CROP + (3,):
        raise AssertionError('bad output shapes %s %s'
                             % (segm.shape, soft.shape))
    if not np.isfinite(soft).all() or segm.min() < 0 or segm.max() > 2:
        raise AssertionError('non-finite or out-of-range output')


def _warm_ms(torch, fn, n_images):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n_images


def _agreement(name, segm, slic, fixture):
    from pyimsegm_tpu_torch.utils.metrics import adjusted_rand_score
    ars = adjusted_rand_score(segm, fixture['segm'])
    slic_eq = float((slic == fixture['slic']).mean())
    print('%s image 0 vs JAX-CPU: segm ARS %.6f (>= 0.98), labels equal %.6f '
          '(>= 0.999)' % (name, ars, slic_eq), flush=True)
    if ars < 0.98 or slic_eq < 0.999:
        raise AssertionError('%s disagrees with the JAX reference' % name)


def path_connectivity_false(torch, model, images, fixture):
    """The connectivity=False path on three images; image 0 against the
    stored result."""
    from pyimsegm_tpu_torch import pipelines

    def segment(img, debug=None):
        return pipelines.segment_color2d_slic_features_model_graphcut(
            img, model, FEATURES, sp_size=SP_SIZE, sp_regul=SP_REGUL,
            gc_regul=GC_REGUL, debug_visual=debug, connectivity=False)

    def run():
        debug = {}
        outs = [segment(images[0], debug)]
        return outs + [segment(img) for img in images[1:3]], debug

    (outs, debug), _ = _drive('connectivity=False path', PATH_FALSE, run)
    for segm, soft in outs:
        _check_outputs(segm, soft)
    _agreement('connectivity=False', outs[0][0], debug['slic'], fixture)
    ms = _warm_ms(torch, lambda: [segment(img) for img in images[:3]], 3)
    print('connectivity=False warm ms per 884x1200 image: %.3f' % ms,
          flush=True)


def path_bench(torch, model, images, fixture_conn):
    """The bench path: the single-image call at connectivity=True, then the
    batch of eight; returns the launch counts."""
    from pyimsegm_tpu_torch import pipelines
    from pyimsegm_tpu_torch.parallel import batch

    def segment(img, debug=None):
        return pipelines.segment_color2d_slic_features_model_graphcut(
            img, model, FEATURES, sp_size=SP_SIZE, sp_regul=SP_REGUL,
            gc_regul=GC_REGUL, debug_visual=debug)

    def run_batch():
        return batch.segment_images_batch(
            stack, model, FEATURES, sp_size=SP_SIZE, sp_regul=SP_REGUL,
            gc_regul=GC_REGUL)

    stack = np.stack(images)

    def run():
        debug = {}
        singles = [segment(images[0], debug)]
        singles += [segment(img) for img in images[1:]]
        return singles, debug, run_batch()

    (singles, debug, (segms, probs)), launches = _drive(
        'bench path', PATH_BENCH, run,
        forbidden=('reach_absorb', 'reach_absorb_fused', 'anchor_seed'))
    if launches['slic_multi_update'] != launches['slic_update_labels']:
        raise AssertionError('bench path: %d SLIC schedule calls for %d '
                             'images' % (launches['slic_multi_update'],
                                         launches['slic_update_labels']))
    for segm, soft in singles:
        _check_outputs(segm, soft)
    _agreement('connectivity=True', singles[0][0], debug['slic'],
               fixture_conn)
    for i, (segm, soft) in enumerate(singles):
        if not (np.array_equal(segms[i], segm)
                and np.array_equal(probs[i], soft)):
            raise AssertionError('batch image %d differs from the single-'
                                 'image call' % i)
    print('batch of %d equals the single-image calls image for image'
          % len(images), flush=True)
    mpix = CROP[0] * CROP[1] / 1e6
    ms_one = _warm_ms(torch, lambda: [segment(img) for img in images],
                      len(images))
    ms_batch = _warm_ms(torch, run_batch, len(images))
    print('bench path warm ms per 884x1200 image: single-image call %.3f '
          '(%.3f MPix/s), batch of %d %.3f (%.3f MPix/s)'
          % (ms_one, mpix / ms_one * 1e3, len(images), ms_batch,
             mpix / ms_batch * 1e3), flush=True)
    return launches


def path_noise(torch, model, fixture):
    """The bench path's single-image call on bench.py's first two noise
    images, with connectivity=False and at the default, against the JAX-CPU
    outputs of ``tests/data/torch_port_fixture_noise.npz``."""
    from pyimsegm_tpu_torch import pipelines
    from pyimsegm_tpu_torch.utils.metrics import adjusted_rand_score
    segment = pipelines.segment_color2d_slic_features_model_graphcut
    rng = np.random.default_rng(0)
    for i in range(2):
        img = rng.random(CROP + (3,), dtype=np.float32)
        out = {}
        for conn in (False, True):
            debug = {}
            segm, soft = segment(
                img, model, FEATURES, sp_size=SP_SIZE, sp_regul=SP_REGUL,
                gc_regul=GC_REGUL, debug_visual=debug, connectivity=conn)
            _check_outputs(segm, soft)
            out[conn] = (segm, debug['slic'])
        slic_eq = float((out[False][1] == fixture['slic%d' % i]).mean())
        enf_eq = float((out[True][1] == fixture['enforced%d' % i]).mean())
        ars = adjusted_rand_score(out[True][0], fixture['segm%d' % i])
        print('noise image %d vs JAX-CPU: SLIC labels equal %.6f (>= 0.999), '
              'enforced labels equal %.6f (>= %g), segm ARS %.6f (>= 0.98)'
              % (i, slic_eq, enf_eq, NOISE_ENFORCED_BAR, ars), flush=True)
        if slic_eq < 0.999 or enf_eq < NOISE_ENFORCED_BAR or ars < 0.98:
            raise AssertionError('noise image %d disagrees with the JAX '
                                 'reference' % i)


def path_fit(torch, images, fixture):
    """The unsupervised fit path at full width; returns the launch
    counts."""
    from pyimsegm_tpu_torch import pipelines, superpixels
    from pyimsegm_tpu_torch.models import gmm
    from pyimsegm_tpu_torch.models.class_model import (
        class_model_from_numpy, estim_class_model)
    from pyimsegm_tpu_torch.parallel import batch
    from pyimsegm_tpu_torch.utils.metrics import adjusted_rand_score

    kw = dict(sp_size=SP_SIZE, sp_regul=SP_REGUL, gc_regul=GC_REGUL)
    jax_model = class_model_from_numpy(fixture).to(DEVICE)

    def fit_one(img, debug=None):
        return pipelines.pipe_color2d_slic_features_model_graphcut(
            img, NB_CLASSES, FEATURES_FIT, debug_visual=debug, **kw)

    def run():
        debug = {}
        fitted = fit_one(images[0], debug)
        carried = pipelines.segment_color2d_slic_features_model_graphcut(
            images[0], jax_model, FEATURES_FIT, **kw)
        slico = superpixels.segment_slic_img2d(
            images[0], sp_size=SP_SIZE, relative_compact=SP_REGUL, slico=True)
        color = pipelines.segment_color2d_slic_features_model_graphcut(
            images[1], jax_model, FEATURES_FIT, gc_edge_type='color', **kw)
        group, _ = pipelines.estim_model_classes_group(
            images[:3], NB_CLASSES, FEATURES_FIT, sp_size=SP_SIZE,
            sp_regul=SP_REGUL)
        batched = batch.segment_images_batch(np.stack(images[:3]), group,
                                             FEATURES_FIT, **kw)
        single = pipelines.segment_color2d_slic_features_model_graphcut(
            images[2], group, FEATURES_FIT, **kw)
        return debug, fitted, carried, slico, color, batched, single

    (debug, fitted, carried, slico, color, batched, single), launches = \
        _drive('fit path', PATH_FIT, run)
    for segm, soft in (fitted, carried, color, single):
        _check_outputs(segm, soft)
    if not (np.array_equal(batched[0][2], single[0])
            and np.array_equal(batched[1][2], single[1])):
        raise AssertionError('fit path: batch image 2 differs from the '
                             'single-image call')

    slic_eq = float((debug['slic'] == fixture['slic']).mean())
    diff = debug['slic'] != fixture['slic']
    touched = np.zeros(fixture['features'].shape[0], bool)
    touched[debug['slic'][diff]] = True
    touched[fixture['slic'][diff]] = True
    fd = np.abs(debug['features'] - fixture['features'])[~touched]
    feat_ok = bool((fd <= 1e-5 * np.abs(fixture['features'][~touched])
                    + 1e-4).all())
    x = torch.as_tensor(fixture['features'], device=DEVICE)
    w = torch.as_tensor(fixture['weight'], device=DEVICE)
    model = debug['model']
    ll_jax = float(gmm.gmm_score(jax_model.gmm, jax_model.transform(x), w))
    ll_port = float(gmm.gmm_score(model.gmm, model.transform(x), w))
    ll_rel = abs(ll_port - ll_jax) / abs(ll_jax)
    ars_fit = adjusted_rand_score(fitted[0], fixture['segm'])
    ars_carried = adjusted_rand_score(carried[0], fixture['segm'])
    slico_eq = float((slico == fixture['slico']).mean())
    print('fit path image 0 vs JAX-CPU: labels equal %.6f (>= 0.999), '
          'features max diff %.3g on %d / %d unchanged superpixels (rtol '
          '1e-5 + 1e-4), segm ARS %.6f with the card-fitted GMM and %.6f '
          'with the JAX-fitted GMM (>= 0.98), weighted mean log-likelihood '
          'on the JAX features %.6f vs JAX fit %.6f (rel %.3g, <= 1e-3), '
          'SLICO labels equal %.6f (>= 0.999)'
          % (slic_eq, float(fd.max()), int((~touched).sum()), touched.size,
             ars_fit, ars_carried, ll_port, ll_jax, ll_rel, slico_eq),
          flush=True)
    if (slic_eq < 0.999 or not feat_ok or ars_fit < 0.98
            or ars_carried < 0.98 or not ll_rel <= 1e-3 or slico_eq < 0.999):
        raise AssertionError('fit path disagrees with the JAX reference')

    ms_pipe = _warm_ms(torch, lambda: [fit_one(img) for img in images[:3]],
                       3)
    feats = torch.as_tensor(debug['features'], device=DEVICE)
    weight = torch.as_tensor(fixture['weight'], device=DEVICE)
    ms_fit = _warm_ms(torch, lambda: estim_class_model(
        feats, NB_CLASSES, 'GMM', sample_weight=weight), 1)
    print('fit path warm ms per 884x1200 image (SLIC + features + GMM fit + '
          'MRF): %.3f; the GMM fit alone (910 x 15, 9 restarts x 99 EM '
          'iterations): %.3f ms' % (ms_pipe, ms_fit), flush=True)
    return launches


def path_enforce_op(torch, img):
    """``enforce_grid_connectivity`` with centroids reduced from the labels
    (the donor-less moments kernel) and the min-size merge."""
    from pyimsegm_tpu_torch.ops import grid as grid_ops
    from pyimsegm_tpu_torch.ops import slic as slic_ops
    cfg = slic_ops.slic_config(CROP[0], CROP[1], SP_SIZE)
    m = slic_ops.compactness_from_regul(SP_SIZE, SP_REGUL)
    labels = slic_ops.slic_segment_with_features(img, img, cfg, m)[0]

    def run():
        return grid_ops.enforce_grid_connectivity(
            labels, cfg, min_size=int(0.5 * cfg.step * cfg.step))

    out, launches = _drive('enforcement op', PATH_OP, run)
    if out.shape != labels.shape or int(out.min()) < 0 \
            or int(out.max()) >= cfg.n_segments:
        raise AssertionError('enforcement op: bad labels')
    return launches


def _tile(torch, shape, seed=0):
    """A synthetic colour tile on the card and its SLIC kernels' labels and
    centroids at sp_size 35."""
    from pyimsegm_tpu_torch.ops import slic as slic_ops
    from pyimsegm_tpu_torch.utils.data_samples import \
        sample_color_image_rand_segment
    img = torch.as_tensor(sample_color_image_rand_segment(
        shape, 3, rand_seed=seed)[0], device=DEVICE)
    cfg = slic_ops.slic_config(shape[0], shape[1], SP_SIZE)
    m = slic_ops.compactness_from_regul(SP_SIZE, SP_REGUL)
    labels, _, centers, _ = slic_ops.slic_segment_with_features(img, img,
                                                                 cfg, m)
    return img, labels, centers, cfg


def kernel_phases_wide(torch):
    """Rows 13 and 14 from the anchor seed, each against its twin and
    against row 12 on the same labels and centres, at both tile geometries;
    records at each row's own route geometry, and the anchor seed's."""
    from pyimsegm_tpu_torch.ops import connectivity_cuda as cc
    from pyimsegm_tpu_torch.ops import enforce_cuda, grid_cuda
    from pyimsegm_tpu_torch.ops import grid as grid_ops
    records = []
    routes = {TILE_14: ('reach_absorb_fused', 'pyimsegm_tpu/ops/'
                        'connectivity_pallas.py:379', 1),
              TILE_13: ('reach_absorb', 'pyimsegm_tpu/ops/'
                        'connectivity_pallas.py:310', 2)}
    from pyimsegm_tpu_torch.ops import slic as slic_ops
    m = slic_ops.compactness_from_regul(SP_SIZE, SP_REGUL)
    for shape, (own, replaces, per_call) in routes.items():
        img, labels, centers, cfg = _tile(torch, shape)
        check_schedule(torch, *slic_ops._prepare_chw(img, cfg), m, cfg,
                       'tile %dx%d' % shape)
        _check_pair_count(torch, grid_cuda, labels, cfg,
                          'SLIC labels of tile %dx%d' % shape)
        _check_adjacency(torch, grid_cuda, labels, cfg,
                         'SLIC labels of tile %dx%d' % shape)
        want_route = 'rafused' if own == 'reach_absorb_fused' else 'two'
        route = grid_ops._enforce_route(cfg)
        if route != want_route:
            raise AssertionError('%s: route %s' % (shape, route))
        seed = enforce_cuda.anchor_seed(labels, centers, cfg)
        seed_p = enforce_cuda._anchor_seed_plain(labels, centers, cfg)
        row12 = enforce_cuda.enforce_fused(labels, centers, cfg)
        twin = enforce_cuda._connect_components(labels, seed.bool(), cfg)
        torch.cuda.synchronize()
        if not torch.equal(seed.bool(), seed_p):
            raise AssertionError('anchor_seed differs from its twin')
        for name in ('reach_absorb', 'reach_absorb_fused'):
            before = cc.LAUNCHES[name]
            out = getattr(cc, name)(labels, seed, cfg)
            n = cc.LAUNCHES[name] - before
            torch.cuda.synchronize()
            sweeps, rounds = cc.grid_passes(cc.LAST_FLAGS, cfg)
            d_twin = int((out != twin).sum())
            d_12 = int((out != row12).sum())
            print('%s at %dx%d: %d kernel launch(es) per call, %d reach '
                  'sweeps + %d absorb rounds = %d grid passes (of %d the caps '
                  'allow); pixels differing from the twin %d, from row 12 %d; '
                  '%d of %d pixels relabelled'
                  % (name, shape[0], shape[1], n, sweeps, rounds,
                     2 * (sweeps + rounds),
                     2 * (cc.MAX_SWEEPS + cc.absorb_rounds(cfg)), d_twin,
                     d_12, int((out != labels).sum()), labels.numel()),
                  flush=True)
            if d_twin or d_12 or n != (2 if name == 'reach_absorb' else 1):
                raise AssertionError('%s disagrees at %s' % (name, shape))
        _check_pair_count(torch, grid_cuda, row12, cfg,
                          'enforced labels of tile %dx%d' % shape)
        _check_adjacency(torch, grid_cuda, row12, cfg,
                         'enforced labels of tile %dx%d' % shape)
        px = shape[0] * shape[1]
        plain_ms = _time_ms(lambda: enforce_cuda._connect_components(
            labels, seed.bool(), cfg), reps=2)
        ms12 = _time_ms(lambda: enforce_cuda.enforce_fused(labels, centers,
                                                           cfg))
        print('%s at %dx%d: row 12 on the same labels %.4f ms (seed '
              'included)' % (own, shape[0], shape[1], ms12), flush=True)
        records.append(_record(
            own, 'pyimsegm_tpu_torch/csrc/connectivity.cu', replaces, 0.0,
            lambda: getattr(cc, own)(labels, seed, cfg), plain_ms,
            'exact vs twin and row 12 (%d launch(es) per '
            'call)' % per_call,
            # i32 labels + u8 seed in, i32 labels out; per pixel one pass of
            # 4 neighbour compares and a scan step
            px * 9, px * 10))
        if own == 'reach_absorb':
            records.append(_record(
                'anchor_seed', 'pyimsegm_tpu_torch/csrc/enforce.cu',
                'pyimsegm_tpu/ops/enforce_pallas.py:297', 0.0,
                lambda: enforce_cuda.anchor_seed(labels, centers, cfg),
                _time_ms(lambda: enforce_cuda._anchor_seed_plain(
                    labels, centers, cfg), reps=3),
                'exact',
                # i32 labels + centroids in, u8 seed out; the distance (6)
                # and the window test per pixel
                px * 5 + cfg.n_segments * 8, px * 8))
    return records


def row7_phases(torch, img):
    """Row 7 (the donor-less moments) at the F of the texture battery
    stacks, on the SLIC kernels' labels of image 0."""
    from pyimsegm_tpu_torch.ops import grid_cuda
    from pyimsegm_tpu_torch.ops import slic as slic_ops
    cfg = slic_ops.slic_config(CROP[0], CROP[1], SP_SIZE)
    m = slic_ops.compactness_from_regul(SP_SIZE, SP_REGUL)
    labels = slic_ops.slic_segment_with_features(img, img, cfg, m)[0]
    px, k = CROP[0] * CROP[1], cfg.n_segments
    rng = np.random.default_rng(3)
    records = []
    for f in (18, 60):
        data = torch.as_tensor(rng.normal(size=CROP + (f,)).astype(
            np.float32), device=DEVICE)
        got = grid_cuda.grid_moments_apply(data, labels, None, cfg)[1]
        want = grid_cuda._grid_moments_apply_plain(data, labels, None, cfg)[1]
        torch.cuda.synchronize()
        ok, err = _sums_agree(got, want)
        if not ok:
            raise AssertionError('grid_moments F=%d: max diff %g' % (f, err))
        flat = labels.reshape(-1).long()
        stacked = torch.cat([data, data * data,
                             torch.ones_like(data[..., :3])],
                            dim=-1).reshape(px, 2 * f + 3)
        records.append(_record(
            'grid_moments_f%d' % f, 'pyimsegm_tpu_torch/csrc/grid.cu',
            'pyimsegm_tpu/ops/grid_pallas.py:195', err,
            lambda: grid_cuda.grid_moments_apply(data, labels, None, cfg),
            _time_ms(lambda: grid_cuda._grid_moments_apply_plain(
                data, labels, None, cfg)),
            'sums within rtol 1e-5 + 1e-5 x channel max (F = %d)' % f,
            # f32 (H, W, F) + i32 labels in, (K, 2F+3) sums out; F squares
            # and 2F+3 sums per pixel
            px * (4 * f + 4) + k * (2 * f + 3) * 4, px * (3 * f + 3),
            _time_ms(lambda: torch.zeros((k, 2 * f + 3), device=DEVICE)
                     .index_add_(0, flat, stacked)), max_kernels=2))
    return records


#: F of rows 6 and 7 held against their twins by reduce_phases: the paths'
#: (row 6: the colour stacks' 3, 4 and 7 and config 2's tLBP 30, which
#: loads 2 channels a thread; row 7: the colour 3 and the battery stacks'
#: 18 and 60), 1, 5 and 61 (one channel a thread, odd widths, an odd F
#: beyond 60), 15 and 40, and two channel ranges: 129 at 1 channel a
#: thread, 258 at 2 and 260 at 4
REDUCE_F = {'grid_reduce': (1, 3, 4, 5, 7, 15, 30, 40, 61, 129, 258, 260),
            'grid_moments': (1, 3, 5, 18, 60, 61, 129, 260)}


def _damaged_labels(torch, labels, cfg, seed):
    """``labels`` with 1 pixel in 50 damaged: -2 holes, ids outside their
    pixel's 3x3 window, ids >= K beyond every window; and the last two rows
    set to ids >= K inside their tiles' windows (whose sums route off the
    grid)."""
    rng = np.random.default_rng(seed)
    bad = labels.cpu().numpy().copy()
    flat = bad.reshape(-1)
    idx = rng.choice(flat.size, flat.size // 50, replace=False)
    q = len(idx) // 3
    flat[idx[:q]] = -2
    flat[idx[q:2 * q]] = (flat[idx[q:2 * q]] + 3 * cfg.grid_w + 3) \
        % cfg.n_segments
    flat[idx[2 * q:]] = 2 ** 31 - 1 - rng.integers(0, 5, len(idx) - 2 * q)
    bad[-2:] = cfg.n_segments + np.arange(bad.shape[1])[None] // cfg.step
    return torch.as_tensor(bad, device=labels.device)


#: row 1's shapes beyond the bench geometry: widths no multiple of 4 or
#: 32, images smaller than the blur radius (the reflection wraps more than
#: once), and the two whole-slide tiles
PREP_SHAPES = ((883, 1197), (57, 101), (3, 7), (7, 3), (4, 2), (1, 1),
               (2, 9)) + (TILE_14, TILE_13)


def prep_phases(torch, img):
    """Row 1 against its twin (``_check_blur_lab``) on image 0 as a gray
    image stacked to RGB, in 0-255, with one NaN pixel, on a constant image,
    and on synthetic images of ``PREP_SHAPES``."""
    from pyimsegm_tpu_torch.ops import prep_cuda
    from pyimsegm_tpu_torch.utils.data_samples import \
        sample_color_image_rand_segment
    gray = img.mean(dim=-1)
    nan = img.clone()
    nan[100, 200, 1] = float('nan')
    cases = [('gray stacked to RGB', torch.stack([gray] * 3, dim=-1)),
             ('in 0-255', img * 255.0),
             ('one NaN pixel', nan),
             ('constant 0.5', torch.full_like(img, 0.5))]
    for i, shape in enumerate(PREP_SHAPES):
        cases.append(('%dx%d' % shape, torch.as_tensor(
            sample_color_image_rand_segment(shape, 3, rand_seed=i)[0],
            device=img.device)))
    for what, image in cases:
        _check_blur_lab(torch, prep_cuda, image, what)


def minsize_count_phases(torch, img):
    """Rows 10 and 11 against their twins (``_check_pair_count``,
    ``_check_adjacency``) on damaged labels (-1 and -2 holes, ids outside
    their window, ids >= K inside and beyond the windows, the last two rows
    >= K) of image 0, and on the SLIC labels of synthetic images at ODD and
    ONE_PX and their damaged labels."""
    from pyimsegm_tpu_torch.ops import grid_cuda
    from pyimsegm_tpu_torch.ops import slic as slic_ops
    from pyimsegm_tpu_torch.utils.data_samples import \
        sample_color_image_rand_segment
    m = slic_ops.compactness_from_regul(SP_SIZE, SP_REGUL)
    cfg = slic_ops.slic_config(CROP[0], CROP[1], SP_SIZE)
    labels = slic_ops.slic_segment_with_features(img, img, cfg, m)[0]
    bad = _damaged_labels(torch, labels, cfg, seed=5)
    bad.view(-1)[::97] = -1
    odd = torch.as_tensor(sample_color_image_rand_segment(
        ODD, 3, rand_seed=1)[0], device=img.device)
    cfg_odd = slic_ops.slic_config(ODD[0], ODD[1], SP_SIZE)
    labels_odd = slic_ops.slic_segment_with_features(odd, odd, cfg_odd, m)[0]
    # the last tile row and column one pixel wide, as at 4096x4096
    one = torch.as_tensor(sample_color_image_rand_segment(
        ONE_PX, 3, rand_seed=2)[0], device=img.device)
    cfg_one = slic_ops.slic_config(ONE_PX[0], ONE_PX[1], SP_SIZE)
    labels_one = slic_ops.slic_segment_with_features(one, one, cfg_one, m)[0]
    for lab, c, what in (
            (bad, cfg, 'damaged labels of image 0'),
            (labels_odd, cfg_odd, 'SLIC labels at %dx%d' % ODD),
            (_damaged_labels(torch, labels_odd, cfg_odd, seed=6), cfg_odd,
             'damaged labels at %dx%d' % ODD),
            (labels_one, cfg_one, 'SLIC labels at %dx%d' % ONE_PX),
            (_damaged_labels(torch, labels_one, cfg_one, seed=9), cfg_one,
             'damaged labels at %dx%d' % ONE_PX)):
        _check_pair_count(torch, grid_cuda, lab, c, what)
        _check_adjacency(torch, grid_cuda, lab, c, what)


def reduce_phases(torch):
    """Rows 6 and 7 against their twins (``_sums_agree``) on the SLIC
    kernels' labels of image 0 at CROP and at ODD, each also damaged
    (``_damaged_labels``), at every F of REDUCE_F (row 6 on f32 and bf16
    data); every call twice, with equal bits."""
    from pyimsegm_tpu_torch.ops import grid_cuda
    from pyimsegm_tpu_torch.ops import slic as slic_ops
    from pyimsegm_tpu_torch.utils.data_samples import \
        sample_color_image_rand_segment
    rng = np.random.default_rng(6)
    for shape in (CROP, ODD):
        img = torch.as_tensor(sample_color_image_rand_segment(
            shape, 3, rand_seed=0)[0], device=DEVICE)
        cfg = slic_ops.slic_config(shape[0], shape[1], SP_SIZE)
        m = slic_ops.compactness_from_regul(SP_SIZE, SP_REGUL)
        labels = slic_ops.slic_segment_with_features(img, img, cfg, m)[0]
        labels = labels.contiguous()
        for kind, lab in (('SLIC', labels),
                          ('damaged', _damaged_labels(torch, labels, cfg, 1))):
            cases = [('grid_reduce', f, dtype)
                     for f in REDUCE_F['grid_reduce']
                     for dtype in (torch.float32, torch.bfloat16)]
            cases += [('grid_moments', f, torch.float32)
                      for f in REDUCE_F['grid_moments']]
            bad = []
            for name, f, dtype in cases:
                data = torch.as_tensor(rng.normal(size=shape + (f,)).astype(
                    np.float32), device=DEVICE).to(dtype)
                if name == 'grid_reduce':
                    got, again = (grid_cuda.grid_reduce(data, lab, cfg)
                                  for _ in range(2))
                    want = grid_cuda._grid_reduce_plain(data, lab, cfg)
                else:
                    got, again = (grid_cuda.grid_moments_apply(
                        data, lab, None, cfg)[1] for _ in range(2))
                    want = grid_cuda._grid_moments_apply_plain(
                        data, lab, None, cfg)[1]
                torch.cuda.synchronize()
                ok, diff = _sums_agree(got, want)
                if not (ok and torch.equal(got, again)):
                    bad.append('%s F=%d %s (max diff %g, two runs equal %s)'
                               % (name, f, dtype, diff,
                                  torch.equal(got, again)))
            print('rows 6 / 7 at %dx%d on %s labels: %d calls (row 6 F %s, '
                  'f32 and bf16; row 7 F %s) within rtol 1e-5 + 1e-5 x '
                  'channel max of their twins, each run twice with equal '
                  'bits: %s'
                  % (shape[0], shape[1], kind, len(cases),
                     REDUCE_F['grid_reduce'], REDUCE_F['grid_moments'],
                     'yes' if not bad else 'NO: ' + '; '.join(bad)),
                  flush=True)
            if bad:
                raise AssertionError('rows 6 / 7 disagree at %s on %s '
                                     'labels' % (shape, kind))


#: seed steps above the former caps of row 7 (1024; at 2100 a tile's sum
#: of rows passes 2^32, at 3500 a warp's share of it, ~5.4e9, at F = 3),
#: rows 10 and 11 (4095: a tile row and the next no longer fit the stage)
#: and row 6 (16384: a tile row no longer fits the code map): (rows,
#: shape, step), partial last tiles where the shape has several
BIG_STEPS = ((('grid_moments',), (1100, 2100), 1025),
             (('grid_moments',), (2100, 4200), 2100),
             (('grid_moments',), (3500, 7000), 3500),
             (('grid_pair_count', 'grid_adjacency'), (40, 8200), 4097),
             (('grid_reduce',), (16, 16400), 16385))


def _grid_labels(torch, shape, step, seed):
    """Grid-structured labels at seed step ``step``, made with numpy: each
    5x5 block of pixels takes its tile's seed moved by a random offset in
    -1..1 (kept on the grid), then 1 pixel in 50 set to a random id in -2
    .. K + 3 (negative, >= K, or where the grid allows outside its
    window)."""
    h, w = shape
    gh, gw = -(-h // step), -(-w // step)
    rng = np.random.default_rng(seed)
    y, x = np.arange(h)[:, None], np.arange(w)[None, :]
    moves = rng.integers(-1, 2, (2, (h + 4) // 5, (w + 4) // 5))
    sy = np.clip(y // step + moves[0][y // 5, x // 5], 0, gh - 1)
    sx = np.clip(x // step + moves[1][y // 5, x // 5], 0, gw - 1)
    labels = (sy * gw + sx).astype(np.int32).reshape(-1)
    idx = rng.choice(labels.size, labels.size // 50, replace=False)
    labels[idx] = rng.integers(-2, gh * gw + 4, idx.size)
    return torch.as_tensor(labels.reshape(shape), device=DEVICE)


def step_phases(torch):
    """Rows 6, 7, 10 and 11 at seed steps above their former caps
    (``BIG_STEPS``) on ``_grid_labels``, each call twice with equal bits:
    rows 10 and 11 and row 7's pixel counts exact, sums within rtol 1e-5 +
    1e-5 x channel max of their twins (F = 3)."""
    from pyimsegm_tpu_torch.ops import grid_cuda
    from pyimsegm_tpu_torch.ops import slic as slic_ops
    rng = np.random.default_rng(10)
    for rows, shape, step in BIG_STEPS:
        cfg = slic_ops.slic_config(shape[0], shape[1], step)
        labels = _grid_labels(torch, shape, step, seed=step)
        what = 'grid labels at %dx%d, step %d' % (shape[0], shape[1], step)
        if 'grid_pair_count' in rows:
            _check_pair_count(torch, grid_cuda, labels, cfg, what)
            _check_adjacency(torch, grid_cuda, labels, cfg, what)
            continue
        data = torch.as_tensor(rng.normal(size=shape + (3,)).astype(
            np.float32), device=DEVICE)
        if rows == ('grid_reduce',):
            got, again = (grid_cuda.grid_reduce(data, labels, cfg)
                          for _ in range(2))
            want = grid_cuda._grid_reduce_plain(data, labels, cfg)
        else:
            got, again = (grid_cuda.grid_moments_apply(data, labels, None,
                                                       cfg)[1]
                          for _ in range(2))
            want = grid_cuda._grid_moments_apply_plain(data, labels, None,
                                                       cfg)[1]
        torch.cuda.synchronize()
        # row 7's channel 2F = 6 counts pixels: integers, exact
        counts_ok = rows == ('grid_reduce',) or torch.equal(got[:, 6],
                                                            want[:, 6])
        ok, diff = _sums_agree(got, want)
        print('%s on %s: sums max diff %g (rtol 1e-5 + 1e-5 x channel max), '
              'pixel counts exact %s, two calls equal %s'
              % (rows[0], what, diff, counts_ok, torch.equal(got, again)),
              flush=True)
        del want
        if not (ok and counts_ok and torch.equal(got, again)):
            raise AssertionError('%s disagrees on %s' % (rows[0], what))


#: row 15 at seed steps whose unbanded layout needs more than the card's
#: 227 KB of shared memory a block (x rows of 640 voxels; z and y tables
#: of 1000 + 1000 entries a candidate): (shape, sp_size, spacing)
BIG_STEPS_3D = (((4, 8, 1302), 640, (160, 160, 1)),
                ((1000, 1000, 6), 1000, (1, 1, 500)))
#: columns of a band in row 15's banded mode (BAND_X of csrc/slic3d.cu)
BAND_X_3D = 96
#: row 8 at a seed step whose tile holds more than 2^31 pixels
BIG_STEP_8 = 46341


def _centre_diff(got, want):
    """Largest |got - want| / (|want| + 10) over the centres' channels."""
    return float(((got - want).abs() / (want.abs() + 10.0)).max())


def big_step_3d_phases(torch):
    """Row 15 at ``BIG_STEPS_3D`` (the banded mode): the labels pass exact
    and the partials pass within rtol 1e-5 + 1e-5 x channel max of their
    twins on the seeds and on the centres after one round (those centres
    within 1e-5 x (|centre| + 10): f32 sums of ~2e6 voxels a tile, in
    another order than the twin's, put centres near 1000 ~5e-4 apart), the
    whole schedule run twice with equal labels, against its twin (>= 0.999
    equal).  The centre bar must catch a planted fault: the twin's centres
    with the voxels of one band (the first ``BAND_X_3D`` columns of tile 0)
    dropped from its sums read above it."""
    from pyimsegm_tpu_torch.ops import slic3d, slic3d_cuda
    from pyimsegm_tpu_torch.ops.slic import compactness_from_regul
    from pyimsegm_tpu_torch.utils.data_samples import sample_gray_volume_3d
    for shape, sp, spacing in BIG_STEPS_3D:
        cfg = slic3d.slic3d_config(shape, sp, spacing)
        m = compactness_from_regul(sp, REGUL_3D)
        vp, c0 = slic3d._prep3d(torch.as_tensor(
            sample_gray_volume_3d(shape, rand_seed=3)[0], device=DEVICE), cfg)
        where = '%dx%dx%d (steps %s)' % (shape + (cfg.steps,))
        _check_passes_3d(torch, vp, c0, m, cfg, where)
        c1 = slic3d_cuda._update3d_plain(
            slic3d_cuda.slic3d_partials(vp, c0, m, cfg), c0)
        c1_twin = slic3d_cuda._update3d_plain(
            slic3d_cuda._slic3d_partials_plain(vp, c0, m, cfg), c0)
        c_diff = _centre_diff(c1, c1_twin)
        _, best_o = slic3d_cuda._assign3d_plain(vp, c0, m, cfg,
                                                want_labels=False)
        best_o[:cfg.steps[0], :cfg.steps[1],
               :min(BAND_X_3D, cfg.steps[2])] = -1
        planted = _centre_diff(slic3d_cuda._update3d_plain(
            slic3d_cuda._pool3d_plain(vp, best_o, cfg), c0), c1_twin)
        _check_passes_3d(torch, vp, c1, m, cfg, where)
        lk, lp = _iterate_vs_twin(torch, vp, c0, m, cfg, 10)
        eq = float((lk == lp).float().mean())
        print('slic3d at %s, banded: passes exact / within rtol 1e-5, '
              'centres after a round max diff %g of (|centre| + 10) (<= '
              '1e-5; a dropped band reads %g), schedule labels equal %.6f '
              '(>= 0.999), two runs equal' % (where, c_diff, planted, eq),
              flush=True)
        if eq < 0.999 or c_diff > 1e-5:
            raise AssertionError('slic3d disagrees at %s' % where)
        if planted <= 1e-5:
            raise AssertionError('the centre bar misses a dropped band at %s'
                                 % where)


def big_step_8_phase(torch):
    """Row 8 at seed step ``BIG_STEP_8``: one 46341 x 46341 tile, K = 1, the
    donor table [0] (no merge): the pixel count equal to the tile's pixels
    rounded once to f32, and sum f within rtol 1e-3 of a float64 torch
    reduction of the same data (per-thread f32 sums of ~2.2e7 values);
    then the anchor seed of rows 13 / 14 on the same labels, whose one
    anchor must be the pixel at the centre."""
    from pyimsegm_tpu_torch.ops import enforce_cuda, grid_cuda
    from pyimsegm_tpu_torch.ops import slic as slic_ops
    step = BIG_STEP_8
    cfg = slic_ops.slic_config(step, step, step)
    torch.cuda.empty_cache()          # ~43 GB below: the earlier paths' cache
    gen = torch.Generator(device=DEVICE).manual_seed(8)
    labels = torch.zeros((step, step), dtype=torch.int32, device=DEVICE)
    feat = torch.rand((step, step, 3), generator=gen, device=DEVICE)
    donor = torch.zeros(1, dtype=torch.int32, device=DEVICE)
    t0 = time.perf_counter()
    merged, sums = grid_cuda.grid_moments_apply(feat, labels, donor, cfg)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    same = torch.equal(merged, labels)
    del merged
    want = torch.zeros(3, dtype=torch.float64, device=DEVICE)
    for r0 in range(0, step, 2048):
        want += feat[r0:r0 + 2048].sum(dim=(0, 1), dtype=torch.float64)
    del feat
    sums = sums.double().cpu().numpy()[0]
    want = want.cpu().numpy()
    # per-thread integer counts, summed exactly, rounded once to f32
    count_want = float(np.float32(step * step))
    rel = float(np.max(np.abs(sums[:3] - want) / want))
    print('grid_moments_apply at step %d (one %dx%d tile, %d pixels): count '
          '%.1f vs %.1f (the pixels rounded once to f32), sum f max rel diff '
          '%.3g vs float64 (<= 1e-3), merged map unchanged %s, %.1f ms'
          % (step, step, step, step * step, sums[6], count_want, rel, same,
             ms), flush=True)
    if sums[6] != count_want or rel > 1e-3 or not same:
        raise AssertionError('grid_moments_apply disagrees at step %d' % step)
    centers = torch.tensor([[step // 2, step // 2]], dtype=torch.float32,
                           device=DEVICE)
    reached = enforce_cuda.anchor_seed(labels, centers, cfg)
    n_reached = int(reached.sum())
    at_centre = bool(reached[step // 2, step // 2])
    print('anchor_seed at step %d: %d anchor pixel(s), the centre one %s'
          % (step, n_reached, at_centre), flush=True)
    if n_reached != 1 or not at_centre:
        raise AssertionError('anchor_seed disagrees at step %d' % step)
    del labels, reached
    torch.cuda.empty_cache()


def _fixture_suffix(fixture, suffix):
    """The arrays of one feature family of the supervised fixture ('' for
    config 2's, '_tlm' for the LM family's), without the suffix."""
    return {k[:len(k) - len(suffix)]: v for k, v in fixture.items()
            if (k.endswith(suffix) if suffix else not k.endswith('_tlm'))}


def _classifier(fixture, suffix=''):
    """The JAX-trained forest of a family, carried to the card."""
    from pyimsegm_tpu_torch.classification import classifier_from_numpy
    return classifier_from_numpy(
        {k[len('clf_'):]: v
         for k, v in _fixture_suffix(fixture, suffix).items()
         if k.startswith('clf_')}, device=DEVICE)


#: kernels the supervised path launches at the bench geometry
PATH_SUP = ('blur_lab', 'slic_multi_update', 'slic_assign', 'enforce_fused',
            'grid_pair_count', 'grid_lookup', 'grid_reduce', 'grid_moments',
            'grid_adjacency_presence')
WIDE = ('reach_absorb', 'reach_absorb_fused', 'anchor_seed')


def path_supervised(torch, images, fixture):
    """Config 2 on image 0 with the JAX-trained forests carried across,
    against the fixture; returns the launch counts."""
    from pyimsegm_tpu_torch import descriptors, pipelines
    from pyimsegm_tpu_torch.ops import slic as slic_ops
    from pyimsegm_tpu_torch.utils.metrics import adjusted_rand_score
    cfg = slic_ops.slic_config(CROP[0], CROP[1], SP_SIZE)
    kw = dict(sp_size=SP_SIZE, sp_regul=SP_REGUL, gc_regul=GC_REGUL_SUP)
    families = (('', FEATURES_SUP), ('_tlm', FEATURES_TLM))
    clfs = {suffix: _classifier(fixture, suffix) for suffix, _ in families}

    segment = pipelines.segment_color2d_slic_features_model_graphcut

    def run():
        out = {}
        for suffix, feats in families:
            debug = {}
            segm, soft = segment(images[0], clfs[suffix], feats,
                                 debug_visual=debug, **kw)
            out[suffix] = (segm, soft, debug)
        return out

    outs, launches = _drive('supervised path', PATH_SUP, run,
                            forbidden=WIDE)
    for suffix, feats in families:
        want = _fixture_suffix(fixture, suffix)
        segm, soft, debug = outs[suffix]
        _check_outputs(segm, soft)
        slic = debug['slic']
        _, names = descriptors.compute_selected_features_color2d(
            torch.as_tensor(images[0], device=DEVICE),
            torch.as_tensor(slic.reshape(-1), device=DEVICE), cfg.n_segments,
            feats, grid_ctx=(torch.as_tensor(slic, device=DEVICE), cfg))
        names_ok = list(names) == [str(n) for n in want['names']]
        slic_eq = float((slic == want['slic']).mean())
        diff = slic != want['slic']
        touched = np.zeros(cfg.n_segments, bool)
        touched[slic[diff]] = True
        touched[want['slic'][diff]] = True
        fd = np.abs(debug['features'] - want['features'])[~touched]
        feat_ok = bool((fd <= 1e-5 * np.abs(want['features'][~touched])
                        + 1e-4).all())
        pd = np.abs(debug['proba'] - want['proba'])[~touched]
        ars = adjusted_rand_score(segm, want['segm'])
        print('supervised path%s image 0 vs JAX-CPU: names equal %s, labels '
              'equal %.6f (>= 0.999), features max diff %.3g on %d / %d '
              'unchanged superpixels (rtol 1e-5 + 1e-4), proba max diff %.3g '
              '(<= 1e-6), superpixels whose proba differs by more %d, segm '
              'ARS %.6f (>= 0.98)'
              % (suffix, names_ok, slic_eq, float(fd.max()),
                 int((~touched).sum()), touched.size, float(pd.max()),
                 int((pd.max(axis=1) > 1e-6).sum()), ars), flush=True)
        proba_ok = suffix == '_tlm' or bool((pd <= 1e-6).all())
        if not (names_ok and slic_eq >= 0.999 and feat_ok and proba_ok
                and ars >= 0.98):
            raise AssertionError('supervised path%s disagrees with the JAX '
                                 'reference' % suffix)
    ms = [_warm_ms(torch, lambda: segment(images[0], clfs[''], FEATURES_SUP,
                                          **kw), 1)
          for _ in range(3)]
    print('supervised path warm ms per 884x1200 image (config 2, carried '
          'forest): %s (best %.3f ms, %.3f MPix/s)'
          % (['%.3f' % t for t in ms], min(ms),
             CROP[0] * CROP[1] / 1e6 / min(ms) * 1e3), flush=True)
    return launches


def _family(fixture, name):
    """A family's JAX-trained classifier of the classifier fixture, carried
    to the card."""
    from pyimsegm_tpu_torch.classification import classifier_from_numpy
    pre = name + '_clf_'
    return classifier_from_numpy(
        {k[len(pre):]: v for k, v in fixture.items() if k.startswith(pre)},
        name, device=DEVICE)


def path_families(torch, images, fixture):
    """Config 2 on image 0 with each family of ``CLF_FAMILIES`` trained by
    the JAX package and carried across, against the classifier fixture;
    returns the launch counts."""
    from pyimsegm_tpu_torch import descriptors, pipelines
    from pyimsegm_tpu_torch.ops import slic as slic_ops
    from pyimsegm_tpu_torch.utils.metrics import adjusted_rand_score
    cfg = slic_ops.slic_config(CROP[0], CROP[1], SP_SIZE)
    kw = dict(sp_size=SP_SIZE, sp_regul=SP_REGUL, gc_regul=GC_REGUL_SUP)
    clfs = {name: _family(fixture, name) for name in CLF_FAMILIES}
    segment = pipelines.segment_color2d_slic_features_model_graphcut

    def run():
        out = {}
        for name in CLF_FAMILIES:
            debug = {}
            segm, soft = segment(images[0], clfs[name], FEATURES_SUP,
                                 debug_visual=debug, **kw)
            out[name] = (segm, soft, debug)
        return out

    outs, launches = _drive('carried families', PATH_SUP, run,
                            forbidden=WIDE)
    slic_want = fixture['slic'].astype(np.int64)
    for name in CLF_FAMILIES:
        segm, soft, debug = outs[name]
        _check_outputs(segm, soft)
        slic = debug['slic']
        if name == CLF_FAMILIES[0]:
            _, names = descriptors.compute_selected_features_color2d(
                torch.as_tensor(images[0], device=DEVICE),
                torch.as_tensor(slic.reshape(-1), device=DEVICE),
                cfg.n_segments, FEATURES_SUP,
                grid_ctx=(torch.as_tensor(slic, device=DEVICE), cfg))
            names_ok = list(names) == [str(n) for n in fixture['names']]
        slic_eq = float((slic == slic_want).mean())
        diff = slic != slic_want
        touched = np.zeros(cfg.n_segments, bool)
        touched[slic[diff]] = True
        touched[slic_want[diff]] = True
        fd = np.abs(debug['features'] - fixture['features'])[~touched]
        feat_ok = bool((fd <= 1e-5 * np.abs(fixture['features'][~touched])
                        + 1e-4).all())
        pd = np.abs(debug['proba'] - fixture[name + '_proba'])[~touched]
        pd = pd.max(axis=1)
        ars = adjusted_rand_score(segm, fixture[name + '_segm'])
        ms = [_warm_ms(torch, lambda: segment(images[0], clfs[name],
                                              FEATURES_SUP, **kw), 1)
              for _ in range(3)]
        print('config 2 with the carried %s, image 0 vs JAX-CPU: names equal '
              '%s, labels equal %.6f (>= 0.999), features max diff %.3g on '
              '%d / %d unchanged superpixels (rtol 1e-5 + 1e-4), proba max '
              'diff %.3g, superpixels above 1e-6 %d, above %g %d (share <= '
              '%g), segm ARS %.6f (>= 0.98); warm ms %s (best %.3f)'
              % (name, names_ok, slic_eq, float(fd.max()),
                 int((~touched).sum()), touched.size, float(pd.max()),
                 int((pd > 1e-6).sum()), PROBA_FAMILY_BAR,
                 int((pd > PROBA_FAMILY_BAR).sum()), PROBA_FAMILY_SHARE,
                 ars, ['%.3f' % t for t in ms], min(ms)), flush=True)
        if not (names_ok and slic_eq >= 0.999 and feat_ok and ars >= 0.98
                and (pd > PROBA_FAMILY_BAR).mean() <= PROBA_FAMILY_SHARE):
            raise AssertionError('config 2 with %s disagrees with the JAX '
                                 'reference' % name)
    return launches


def path_train_families(torch, images, annots, fixture):
    """Each family of ``CLF_FAMILIES`` trained on the card on images 0-2
    with a 3-candidate search: accuracy on the JAX training set within 0.02
    of the JAX classifier's, GradBoost's fit twice with equal parameters
    (AdaBoost's compared and reported); the training ms of each."""
    from pyimsegm_tpu_torch import classification, pipelines
    kw = dict(sp_size=SP_SIZE, sp_regul=SP_REGUL)
    x, y = fixture['train_features'], fixture['train_labels']
    for name in CLF_FAMILIES:

        def train():
            return pipelines.train_classif_color2d_slic_features(
                images[:3], annots[:3], FEATURES_SUP, clf_name=name,
                nb_classif_search=3, device=DEVICE, **kw)

        (clf, _slic, _feats, _labels), _ = _drive(
            'training %s' % name, PATH_SUP[:-1], train, forbidden=WIDE)
        ms = _warm_ms(torch, train, 1)
        acc = clf.score(x, y)
        acc_j = float(fixture[name + '_train_acc'])
        refits = [classification.classifier_to_numpy(classification.Classifier(
            name, seed=clf.seed, device=DEVICE, **clf.hyper).fit(x, y))
            for _ in range(2)]
        same = all(np.array_equal(refits[0][k], refits[1][k])
                   for k in refits[0])
        print('training %s on the card: hyper %s, accuracy on the JAX '
              'training set %.4f vs the JAX classifier %.4f (within 0.02); '
              'two fits with one seed equal: %s; training ms (warm, 3 images, '
              '3 candidates) %.3f'
              % (name, json.dumps(clf.hyper), acc, acc_j, same, ms),
              flush=True)
        if acc < acc_j - 0.02 or (name == 'GradBoost' and not same):
            raise AssertionError('training %s on the card misses the JAX '
                                 'classifier' % name)


def path_gray3d_tlm(torch, fixture):
    """The 3D path with LM texture: at the small fixture's size against it
    (SLIC labels of the stored slices >= 0.999 equal, segm ARS >= 0.98,
    standardised features of the supervoxels whose voxel sets agree within
    1e-2), then at the 3D workload (48x640x768) timed, its output's shape
    and range, the launch of row 15, finite features and mixture
    parameters, and each of the NB_CLASSES_3D classes on at least 1% of the
    voxels checked; returns the launch counts of the full-size run."""
    from pyimsegm_tpu_torch import pipelines
    from pyimsegm_tpu_torch.utils.data_samples import sample_gray_volume_3d
    from pyimsegm_tpu_torch.utils.metrics import (adjusted_rand_score,
                                                  segment_digest)
    shape = tuple(int(s) for s in fixture['shape'])

    def run(vol, debug=None):
        return pipelines.pipe_gray3d_slic_features_model_graphcut(
            vol, NB_CLASSES_3D, FEATURES_3D_TLM, spacing=SPACING_3D,
            sp_size=SP_3D, sp_regul=REGUL_3D, gc_regul=GC_REGUL_3D,
            debug_visual=debug)

    small = torch.as_tensor(sample_gray_volume_3d(shape)[0], device=DEVICE)
    debug = {}
    segm = run(small, debug)
    want = np.unpackbits(fixture['segm_bits'])[:segm.size].reshape(shape)
    ars = adjusted_rand_score(segm, want)
    slic_eq = float((debug['slic'][fixture['slices']]
                     == fixture['slic']).mean())
    same = np.all(segment_digest(debug['slic'], fixture['features'].shape[0])
                  == fixture['digest'], axis=1)
    fd = float(np.abs(debug['features'] - fixture['features'])[same].max())
    print('3D path with tLM at %dx%dx%d vs JAX-CPU: %d features, labels '
          'equal %.6f (>= 0.999), segm ARS %.6f (>= 0.98), supervoxels with '
          'the same voxel set %d / %d, their standardised features max diff '
          '%.3g (<= 1e-2)' % (shape + (debug['features'].shape[1], slic_eq,
                                       ars, int(same.sum()), same.size, fd)),
          flush=True)
    if slic_eq < 0.999 or ars < 0.98 or fd > 1e-2 or same.mean() < 0.99:
        raise AssertionError('3D path with tLM disagrees with the JAX '
                             'reference')
    vol = torch.as_tensor(sample_gray_volume_3d(SHAPE_3D)[0], device=DEVICE)
    debug = {}
    segm, launches = _drive('3D path with tLM', PATH_3D,
                            lambda: run(vol, debug), forbidden=PASSES_3D)
    gmm = debug['model'].gmm
    finite = all(bool(torch.isfinite(a).all()) for a in gmm)
    shares = np.bincount(segm.ravel(), minlength=NB_CLASSES_3D) / segm.size
    # this volume's 23 standardised columns are nearly collinear: where
    # every f32 restart's covariance factor breaks down, the fit is redone
    # in float64 (covariances kept in float64)
    print('3D path with tLM at 48x640x768: features finite %s, mixture '
          'finite %s (covariances in %s), class shares %s (each >= 0.01)'
          % (bool(np.isfinite(debug['features']).all()), finite,
             gmm.covs.dtype, np.round(shares, 4).tolist()), flush=True)
    if segm.shape != SHAPE_3D or segm.min() < 0 \
            or segm.max() >= NB_CLASSES_3D \
            or not np.isfinite(debug['features']).all() or not finite \
            or shares.min() < 0.01:
        raise AssertionError('3D path with tLM: bad segmentation')
    ms = [_warm_ms(torch, lambda: run(vol), 1) for _ in range(2)]
    print('3D path with tLM warm ms per 48x640x768 volume: %s (best %.3f ms, '
          '%.3f MVox/s)' % (['%.3f' % t for t in ms], min(ms),
                            float(np.prod(SHAPE_3D)) / 1e6 / min(ms) * 1e3),
          flush=True)
    return launches


def path_train(torch, images, annots, fixture):
    """Config 2's training on the card on images 0-2; returns the
    classifier."""
    from pyimsegm_tpu_torch import classification, pipelines
    from pyimsegm_tpu_torch.utils.metrics import adjusted_rand_score
    kw = dict(sp_size=SP_SIZE, sp_regul=SP_REGUL)

    def train():
        return pipelines.train_classif_color2d_slic_features(
            images[:3], annots[:3], FEATURES_SUP, nb_classif_search=3, **kw)

    t0 = time.perf_counter()
    (clf, _slic, feats, labels), _ = _drive(
        'training', tuple(k for k in PATH_SUP
                          if k != 'grid_adjacency_presence'), train,
        forbidden=WIDE)
    torch.cuda.synchronize()
    train_ms = (time.perf_counter() - t0) * 1e3
    acc = clf.score(fixture['train_features'], fixture['train_labels'])
    segm, _ = pipelines.segment_color2d_slic_features_model_graphcut(
        images[0], clf, FEATURES_SUP, gc_regul=GC_REGUL_SUP, **kw)
    ars = adjusted_rand_score(segm, annots[0])
    x, y, _ = classification.convert_set_features_labels_2_dataset(
        dict(enumerate(feats)), dict(enumerate(labels)),
        balance_type='unique', drop_labels=[-1])
    refits = [classification.classifier_to_numpy(classification.Classifier(
        clf.name, seed=clf.seed, device=DEVICE, **clf.hyper).fit(x, y))
        for _ in range(2)]
    mine = classification.classifier_to_numpy(clf)
    same = all(np.array_equal(refits[0][k], refits[1][k])
               and np.array_equal(refits[0][k], mine[k]) for k in mine)
    ms_train = _warm_ms(torch, train, 1)
    print('training on the card: %d samples, hyper %s, accuracy on the JAX '
          'training set %.4f vs the JAX forest %.4f, image 0 ARS vs its '
          'annotation %.4f vs %.4f (within 0.02); two fits with one seed '
          'equal: %s; training ms %.3f (first call, with the builds of the '
          'first use) and %.3f (warm)'
          % (len(y), json.dumps(clf.hyper), acc, float(fixture['train_acc']),
             ars, float(fixture['ars_annot']), same, train_ms, ms_train),
          flush=True)
    if (acc < float(fixture['train_acc']) - 0.02
            or ars < float(fixture['ars_annot']) - 0.02 or not same):
        raise AssertionError('training on the card misses the JAX forest')
    return clf


def path_tiles(torch, clf):
    """Whole-slide tiles segmented with the card-trained forest: the 2048 x
    3600 tile must take row 14 and the 4096 x 4096 tile row 13, neither
    row 12; returns the launch counts of each."""
    from pyimsegm_tpu_torch import pipelines
    from pyimsegm_tpu_torch.utils.data_samples import \
        sample_color_image_rand_segment
    counts = {}
    for shape, kernel, other in ((TILE_14, 'reach_absorb_fused',
                                  'reach_absorb'),
                                 (TILE_13, 'reach_absorb',
                                  'reach_absorb_fused')):
        tile = sample_color_image_rand_segment(shape, 3, rand_seed=1)[0]

        def run():
            return pipelines.segment_color2d_slic_features_model_graphcut(
                tile, clf, FEATURES_SUP, sp_size=SP_SIZE, sp_regul=SP_REGUL,
                gc_regul=GC_REGUL_SUP)

        (segm, soft), launches = _drive(
            'tile %dx%d' % shape, (kernel, 'anchor_seed') + PATH_SUP[:3]
            + PATH_SUP[4:], run, forbidden=('enforce_fused', other))
        if segm.shape != shape or soft.shape != shape + (3,) \
                or not np.isfinite(soft).all() \
                or not set(np.unique(segm)) <= set(clf.classes_.tolist()):
            raise AssertionError('tile %s: bad output' % (shape,))
        ms = [_warm_ms(torch, run, 1) for _ in range(2)]
        print('tile %dx%d warm ms: %s (best %.3f ms, %.3f MPix/s)'
              % (shape[0], shape[1], ['%.3f' % t for t in ms], min(ms),
                 shape[0] * shape[1] / 1e6 / min(ms) * 1e3), flush=True)
        counts[shape] = launches
    return counts


#: BASELINE config 4 at the ovary image's size, on the synthetic scenes of
#: ``sample_ovary_scene`` (tools/make_torch_port_fixture.py --only-centers):
#: the scenes' seeds and egg count, the ellipse chain's tissue table
#: (background, follicle, nurse, oocyte), SLIC, RANSAC and overlap
#: parameters, and the annuli radii x labels of the features
OVARY = (647, 1024)
CENTER_TRAIN_SEEDS, CENTER_TEST_SEED, N_EGGS = (0, 1, 2), 3, 4
TABLE_PROB = [0.01, 0.95, 0.95, 0.85]
ELL_SLIC, ELL_REGUL, ELL_INLIERS, ELL_THR, ELL_TRIALS, ELL_OVERLAP = \
    15, 0.1, 0.35, 3, 30, 0.45
N_HIST = 5 * 4
#: bars of the centre chain against JAX: ray distances equal on >= RAY_BAR
#: of (position, angle) entries (any other one step length off), shifts
#: equal on >= SHIFT_BAR of the rows (tests/test_torch_centers.py)
RAY_BAR, SHIFT_BAR = 0.999, 0.99
#: kernels the fused centre detection launches at 647x1024, sp_size 25
#: (and the ellipse chain's gray SLIC at sp_size 15, and the training's
#: SLIC, whose centres come from a segment sum, not row 6)
PATH_CENTERS = ('blur_lab', 'slic_multi_update', 'slic_assign',
                'grid_reduce', 'grid_moments', 'grid_lookup',
                'grid_pair_count', 'enforce_fused')
PATH_SLIC_ENFORCED = tuple(k for k in PATH_CENTERS if k != 'grid_reduce')
#: the centre chain's stages (``pyimsegm:<stage>`` profiler ranges)
CENTER_STAGES = ('slic', 'enforce', 'geometry', 'hist', 'rays', 'shift',
                 'classify', 'cluster')


def _ovary_scenes():
    from pyimsegm_tpu_torch.utils.data_samples import sample_ovary_scene
    return [sample_ovary_scene(OVARY, N_EGGS, rand_seed=s)
            for s in CENTER_TRAIN_SEEDS + (CENTER_TEST_SEED,)]


def slice_kernel_phases(torch, scene, cases=None):
    """Rows 1, 2, 4, 6, 7, 9, 10 and 12 against their twins at the centre
    slice's geometries, 647x1024 at sp_size 25 (the colour scene: the last
    tile row and column 22 and 24 pixels) and at sp_size 15 (the gray
    image of the segmentation, as the ellipse chain's SLIC takes it: 2 and
    4 pixels), each on the labels the kernels produce there; ``cases``
    (what, 'colour' or 'gray', sp_size, regul) names other geometries."""
    from pyimsegm_tpu_torch.ops import enforce_cuda, grid_cuda, prep_cuda
    from pyimsegm_tpu_torch.ops import grid as grid_ops
    from pyimsegm_tpu_torch.ops import slic as slic_ops
    from pyimsegm_tpu_torch.ops import slic_cuda
    img, segm, _ = scene
    gray = segm / float(segm.max())
    if cases is None:
        cases = (('colour scene, sp_size 25', 'colour', 25, 0.3),
                 ('gray segmentation, sp_size 15', 'gray', ELL_SLIC,
                  ELL_REGUL))
    for what, kind, step, regul in cases:
        image = img if kind == 'colour' else gray
        t = torch.as_tensor(np.asarray(image, np.float32), device=DEVICE)
        cfg = slic_ops.slic_config(OVARY[0], OVARY[1], step)
        m = slic_ops.compactness_from_regul(step, regul)
        rgb = t if t.ndim == 3 else torch.stack([t] * 3, dim=-1)
        equal, ulps, _ = _check_blur_lab(torch, prep_cuda, rgb, what)
        lab_chw, centers0 = slic_ops._prepare_chw(t, cfg)
        n_upd = slic_ops.DEFAULT_SLIC_ITERS - 1
        cen = _one_schedule(lambda: slic_cuda.slic_multi_update(
            lab_chw, centers0, m, cfg, n_upd))
        cen_p = slic_cuda._slic_multi_update_plain(lab_chw, centers0, m, cfg,
                                                   n_upd)
        lab_k = slic_cuda.slic_assign(lab_chw, cen, m, cfg)
        lab_p = slic_cuda._slic_assign_plain(lab_chw, cen, m, cfg)
        torch.cuda.synchronize()
        c_err = float((cen - cen_p).abs().max())
        if not (c_err <= 1e-3 and torch.equal(lab_k, lab_p)):
            raise AssertionError('%s: row 2 centres within %g, row 4 %d '
                                 'labels differ' % (what, c_err, int(
                                     (lab_k != lab_p).sum())))
        labels = lab_k[:cfg.height, :cfg.width].contiguous()
        h, w = labels.shape
        py, px = torch.meshgrid(
            torch.arange(h, dtype=torch.float32, device=DEVICE),
            torch.arange(w, dtype=torch.float32, device=DEVICE),
            indexing='ij')
        coords = torch.stack([torch.ones_like(py), py, px], dim=-1)
        ok6, e6 = _sums_agree(grid_cuda.grid_reduce(coords, labels, cfg),
                              grid_cuda._grid_reduce_plain(coords, labels,
                                                           cfg))
        zeros = torch.zeros((h, w, 3), dtype=torch.float32, device=DEVICE)
        mom = grid_cuda.grid_moments_apply(zeros, labels, None, cfg)[1]
        ok7, e7 = _sums_agree(mom, grid_cuda._grid_moments_apply_plain(
            zeros, labels, None, cfg)[1])
        cyx = mom[:, 7:9] / torch.clamp_min(mom[:, 6:7], 1.0)
        enf = enforce_cuda.enforce_fused(labels, cyx, cfg)
        enf_p = enforce_cuda._enforce_fused_plain(labels, cyx, cfg)
        torch.cuda.synchronize()
        if not (ok6 and ok7 and torch.equal(enf, enf_p)):
            raise AssertionError('%s: row 6 within %g (%s), row 7 within %g '
                                 '(%s), row 12 %d pixels differ'
                                 % (what, e6, ok6, e7, ok7,
                                    int((enf != enf_p).sum())))
        _check_pair_count(torch, grid_cuda, enf, cfg, what)
        counts, sym25, counts9 = grid_ops.counts_and_contacts(enf, cfg)
        donor = grid_ops.donor_chain_table(
            counts, sym25, cfg.grid_h, cfg.grid_w,
            int(0.5 * cfg.step * cfg.step), counts9=counts9).to(torch.int32)
        for table in (donor[:, None], _window_donor(torch, cfg,
                                                    DEVICE)[:, None]):
            got = grid_cuda.grid_lookup(table, enf, cfg)
            want = grid_cuda._grid_lookup_plain(table, enf, cfg).to(
                table.dtype)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError('%s: row 9 %d words differ'
                                     % (what, int((got != want).sum())))
        print('slice kernels, %s, K = %d: row 1 bf16 equal %.6f (max %d '
              'ulp), row 2 centres within %.3g, rows 4 / 9 / 10 / 12 exact, '
              'row 6 within %.3g, row 7 within %.3g; %.6f of pixels '
              'relabelled by row 12'
              % (what, cfg.n_segments, equal, ulps, c_err, e6, e7,
                 float((enf != labels).float().mean())), flush=True)


def _stage_device_ms(torch, fn):
    """{stage: device ms} of the ``pyimsegm:<stage>`` ranges in one
    profiled call of ``fn`` (the range's span on the device), the call's
    device busy ms and its kernel launches."""
    from torch.profiler import ProfilerActivity, profile
    from pyimsegm_tpu_torch.utils.device import STAGE_PREFIX
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    stages = {}
    for e in prof.events():
        if e.name.startswith(STAGE_PREFIX) and \
                not str(e.device_type).endswith('CPU'):
            name = e.name[len(STAGE_PREFIX):]
            stages[name] = stages.get(name, 0.0) + e.device_time_total / 1e3
    device = [e for e in prof.events() if str(e.device_type).endswith('CUDA')
              and not e.name.startswith(STAGE_PREFIX)]
    return (stages, sum(e.time_range.elapsed_us() for e in device) / 1e3,
            sum(1 for e in device
                if not e.name.startswith(('Memcpy', 'Memset'))))


def _match_centres(got, want, tol=1.0):
    """True when the centres match one to one within ``tol`` px."""
    got, want = np.asarray(got).reshape(-1, 2), np.asarray(want).reshape(-1, 2)
    if got.shape != want.shape:
        return False
    if not len(want):
        return True
    d = np.sqrt(((got[:, None] - want[None]) ** 2).sum(-1))
    nearest = np.argmin(d, axis=1)
    return bool((d.min(axis=1) <= tol).all()
                and len(set(nearest.tolist())) == len(want))


def _centre_features(torch, segm, points):
    """The fused route's features at ``points``, by its own pieces on the
    card: (histograms (P, 20), rays before the alignment (P, 24), aligned
    rays, shifts) as numpy."""
    from pyimsegm_tpu_torch import centers
    return [t.cpu().numpy() for t in centers._fused_features(
        torch.as_tensor(segm.astype(np.int32), device=DEVICE),
        torch.as_tensor(points, device=DEVICE), 4, centers.CENTER_PARAMS)]


def path_centers(torch, scenes, fixture):
    """The fused centre detection on the test scene with the JAX-trained
    forest carried across, against the fixture; returns the launch
    counts."""
    from pyimsegm_tpu_torch import centers
    from pyimsegm_tpu_torch.classification import classifier_from_numpy
    clf = classifier_from_numpy({k[4:]: v for k, v in fixture.items()
                                 if k.startswith('clf_')}, device=DEVICE)
    img, segm, true_centres = scenes[-1]
    if not centers._fused_ok(clf, dict(centers.CENTER_PARAMS,
                                       **centers.CLUSTER_PARAMS)):
        raise AssertionError('the carried forest does not take the fused '
                             'route')

    def run():
        return centers.load_compute_detect_centers(img, segm, clf)

    out, launches = _drive('centre detection', PATH_CENTERS, run,
                           forbidden=WIDE)
    slic_eq = float((out['slic'] == fixture['slic']).mean())
    # points are the centres of the non-empty superpixels in id order; a
    # superpixel that a differing pixel touches may move, every other one
    # must not
    ids = np.unique(out['slic'])
    diff = out['slic'] != fixture['slic']
    touched = np.isin(ids, np.concatenate([out['slic'][diff],
                                           fixture['slic'][diff]]))
    same_ids = np.array_equal(ids, np.unique(fixture['slic']))
    same_pts = ~touched if same_ids else np.zeros(len(ids), bool)
    points_eq = same_ids and np.array_equal(out['points'][same_pts],
                                            fixture['points'][same_pts])
    hists, raw, aligned, shifts = _centre_features(torch, segm, out['points'])
    want = fixture['features']
    hist_eq = bool(same_ids and np.array_equal(hists[same_pts],
                                               want[same_pts, :N_HIST]))
    ray_eq = float((raw[same_pts] == fixture['rays'][same_pts]).mean())
    rows = np.abs(shifts[same_pts] - fixture['shifts'][same_pts]) <= 1e-3
    aligned_ok = np.array_equal(aligned[same_pts][rows],
                                want[same_pts, N_HIST:][rows])
    centres_ok = _match_centres(out['centers'], fixture['centers'])
    stats = centers.evaluate_detected_centers(out['centers'], true_centres)
    print('centre detection 647x1024 vs JAX-CPU: SLIC labels equal %.6f (>= '
          '0.999), same superpixels %s, points exact on the %d of %d whose '
          'pixels agree %s, histograms there exact %s, rays equal %.6f (>= '
          '%g), shifts equal %.6f of rows (>= %g), aligned rays on those '
          'rows equal %s, %d candidates (JAX %d), centres %d one to one '
          'within 1 px %s; recall %.4f precision %.4f (JAX %.4f / %.4f)'
          % (slic_eq, same_ids, int(same_pts.sum()), len(ids), points_eq,
             hist_eq, ray_eq,
             RAY_BAR, float(rows.mean()), SHIFT_BAR, aligned_ok,
             len(out['candidates']), len(fixture['candidates']),
             len(out['centers']), centres_ok, stats['recall'],
             stats['precision'], float(fixture['recall']),
             float(fixture['precision'])), flush=True)
    if not (slic_eq >= 0.999 and points_eq and hist_eq and ray_eq >= RAY_BAR
            and rows.mean() >= SHIFT_BAR and aligned_ok and centres_ok
            and stats['recall'] >= float(fixture['recall'])
            and stats['precision'] >= float(fixture['precision'])):
        raise AssertionError('centre detection disagrees with the JAX '
                             'reference')
    ms = [_warm_ms(torch, run, 1) for _ in range(3)]
    stages, busy, n_kernels = _stage_device_ms(torch, run)
    wall = _warm_ms(torch, run, 1)
    print('centre detection warm ms per 647x1024 image: %s (best %.3f ms); '
          'stage device ms %s (sum %.3f); device busy %.3f ms of a %.3f ms '
          'call in %d CUDA kernels'
          % (['%.3f' % t for t in ms], min(ms), json.dumps(
              {k: round(stages.get(k, 0.0), 4) for k in CENTER_STAGES}),
             sum(stages.values()), busy, wall, n_kernels), flush=True)
    return launches


def path_train_centers(torch, scenes, fixture):
    """``train_center_classifier`` on the three training scenes at full size
    with one search candidate, then the detection with that forest; held
    by quality against the JAX-trained forest's detection (TP and FP
    within one centre); returns the launch counts."""
    from pyimsegm_tpu_torch import centers

    def train():
        return centers.train_center_classifier(
            [s[1] for s in scenes[:-1]], [s[0] for s in scenes[:-1]],
            [s[2] for s in scenes[:-1]], params={'nb_classif_search': 1})

    t0 = time.perf_counter()
    (clf, data), launches = _drive('centre training', PATH_SLIC_ENFORCED,
                                   train, forbidden=WIDE)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    warm_ms = _warm_ms(torch, train, 1)
    img, segm, true_centres = scenes[-1]
    out = centers.load_compute_detect_centers(img, segm, clf)
    got = centers.evaluate_detected_centers(out['centers'], true_centres)
    tp_jax = round(float(fixture['recall']) * len(true_centres))
    fp_jax = round(tp_jax / float(fixture['precision'])) - tp_jax \
        if float(fixture['precision']) > 0 else len(fixture['centers'])
    acc = clf.score(fixture['train_features'], fixture['train_labels'])
    print('centre training on the card: %d points, forest accuracy on the '
          'JAX training points %.4f; detection with it TP %d FP %d FN %d '
          '(JAX forest TP %d FP %d, within one centre); training ms %.3f '
          '(first call) and %.3f (warm)'
          % (sum(len(d['points']) for d in data.values()), acc, got['TP'],
             got['FP'], got['FN'], tp_jax, fp_jax, first_ms, warm_ms),
          flush=True)
    if got['TP'] < tp_jax - 1 or got['FP'] > fp_jax + 1:
        raise AssertionError('the card-trained forest misses the JAX '
                             'forest\'s detection')
    return launches


def path_ellipses(torch, scenes, fixture):
    """The ellipse chain on the test scene's true centres against the
    fixture: the gray SLIC (>= 0.999), the ray-edge boundary points (>=
    RAY_BAR equal), RANSAC under ``np.random.seed(0)`` (parameters within
    1e-6 relative), the object map (>= 0.999); returns the launch
    counts."""
    from pyimsegm_tpu_torch import ellipse_fitting as ell
    _, segm, true_centres = scenes[-1]

    def run():
        slic, points_all, labels = ell.get_slic_points_labels(
            segm, slic_size=ELL_SLIC, slic_regul=ELL_REGUL)
        weights = np.bincount(slic.ravel())
        boundary = ell.prepare_boundary_points_ray_edge(segm, true_centres,
                                                        close_points=5)
        np.random.seed(0)
        obj = np.zeros(segm.shape, dtype=int)
        fits = []
        for i, pts in enumerate(boundary):
            model, inliers = ell.ransac_segm(
                np.asarray(pts), ell.EllipseModelSegm, points_all, weights,
                labels, [TABLE_PROB], ELL_INLIERS, ELL_THR,
                max_trials=ELL_TRIALS)
            if model is None:
                fits.append((np.full(5, np.nan), -1))
                continue
            fits.append((np.asarray(model.params), int(inliers.sum())))
            obj = ell.add_overlap_ellipse(obj, model.params, i + 1,
                                          thr_overlap=ELL_OVERLAP)
        return slic, boundary, fits, obj

    (slic, boundary, fits, obj), launches = _drive(
        'ellipse chain', PATH_SLIC_ENFORCED, run, forbidden=WIDE)
    slic_eq = float((slic == fixture['ell_slic']).mean())
    counts_eq = [len(b) for b in boundary] == fixture['ell_counts'].tolist()
    pts = np.concatenate(boundary)
    pts_eq = float(np.all(pts == fixture['ell_points'], axis=1).mean()) \
        if counts_eq else 0.0
    inl_eq = [n == m for (_, n), m in zip(fits, fixture['ell_inliers'])]
    rel = [float(np.max(np.abs(p - q) / np.abs(q)))
           for (p, _), q in zip(fits, fixture['ell_params'])]
    obj_eq = float((obj == fixture['ell_segm']).mean())
    print('ellipse chain 647x1024 vs JAX-CPU: gray SLIC labels equal %.6f '
          '(>= 0.999), boundary points equal %.6f (>= %g), inlier counts '
          'equal %s, parameters max relative diff %s (<= 1e-6 where the '
          'inliers agree), object map equal %.6f (>= 0.999)'
          % (slic_eq, pts_eq, RAY_BAR, inl_eq, ['%.3g' % r for r in rel],
             obj_eq), flush=True)
    if not (slic_eq >= 0.999 and pts_eq >= RAY_BAR and obj_eq >= 0.999
            and all(r <= 1e-6 for r, same in zip(rel, inl_eq) if same)):
        raise AssertionError('the ellipse chain disagrees with the JAX '
                             'reference')
    ms = [_warm_ms(torch, run, 1) for _ in range(3)]
    print('ellipse chain warm ms per 647x1024 image (%d centres): %s (best '
          '%.3f ms)' % (len(true_centres), ['%.3f' % t for t in ms],
                        min(ms)), flush=True)
    return launches


#: config 5 (bench_all.py cfg5) on the synthetic ovary scenes, as
#: tools/make_torch_port_fixture.py writes its fixture: the shape model's
#: training scenes (24 eggs), the test scene (its K = 3,034 labels take the
#: edge-list solve) and a second one whose K = 3,036 take the grid solve,
#: the SLIC, the tissue table, the RG2Sp energy,
#: the one-shot GraphCut's radial prior and the compat model's classes
RG_SHAPE_SEEDS, RG_TEST_SEED, RG_GRID_SEED = (0, 1, 2, 4, 5, 6), 3, 10
RG_SP, RG_REGUL, RG_RAY_STEP = 15, 0.2, 25
RG_TABLE = [0.1, 0.9, 0.75, 0.9, 0.9]
RG_PARAMS = dict(coef_shape=5., coef_pairwise=15.,
                 prob_label_trans=[0.1, 0.03], nb_iter=100)
RG_OBJ_SHAPE = dict(coef_shape=1., shape_mean_std=(100., 20.))
#: bars of phase 13: each egg's object pixel IoU against JAX's; each egg's
#: IoU against the true egg no worse than JAX's by more than RG_TRUE_SLACK;
#: the pixel GraphCut's energy at most RG_ENERGY_SLACK above JAX's; the
#: compat SLIC's raw labels equal on >= COMPAT_RAW_BAR of the pixels and
#: the sp_compat segmentation's ARS
RG_IOU_BAR, RG_TRUE_SLACK, RG_ENERGY_SLACK = 0.95, 0.02, 0.005
#: RG2Sp's iteration count within RG_ITER_SLACK of JAX's (the stop rule's
#: exact label equality turns on near-ties)
RG_ITER_SLACK = 1
COMPAT_RAW_BAR, COMPAT_ARS_BAR = 0.999, 0.98
#: (the second scene's enforced SLIC labels are held to NOISE_ENFORCED_BAR:
#: 0.9997 of its raw labels agree with JAX's, and the near-tie flips move
#: enforced labels as on the noise images: 0.99898 from the CPU twins)
#: the ranges of an RG2Sp round (``pyimsegm:<stage>``)
RG_STAGES = ('slic', 'upload', 'candidates', 'shape_update', 'unary',
             'solve', 'score', 'fetch')


def _rg_model(fixture, device=DEVICE):
    from pyimsegm_tpu_torch.region_growing import shape_model_from_numpy
    return shape_model_from_numpy({k[len('shape_'):]: v
                                   for k, v in fixture.items()
                                   if k.startswith('shape_')}, device=device)


def _egg_masks(segm, centres):
    """The true egg of each centre: its conn4 component of ``segm > 0``."""
    from scipy import ndimage
    comp, _ = ndimage.label(segm > 0)
    return [comp == comp[int(round(c[0])), int(round(c[1]))]
            for c in centres]


def _object_ious(labels, slic, masks):
    """Pixel IoU of object i + 1 of the superpixel ``labels`` (over
    ``slic``) with ``masks[i]``."""
    obj = np.asarray(labels)[slic]
    return [float(((obj == i + 1) & m).sum() / max(((obj == i + 1) | m)
                                                   .sum(), 1))
            for i, m in enumerate(masks)]


def _observed(launches):
    return {k: v for k, v in launches.items() if v}


def _rg_slic(img, segm):
    """Config 5's SLIC of the scene and its superpixels' foreground
    probabilities."""
    from pyimsegm_tpu_torch import region_growing as rg
    from pyimsegm_tpu_torch import superpixels
    from pyimsegm_tpu_torch.utils.device import stage_range
    with stage_range('slic'):
        slic = superpixels.segment_slic_img2d(
            img, sp_size=RG_SP, relative_compact=RG_REGUL, device=DEVICE)
    return slic, rg.compute_segm_prob_fg(slic, segm, RG_TABLE)


def _timed_rg(torch, call, what):
    """Three warm calls of ``call(history)`` on the host clock, ms per call
    and per iteration, then one profiled call's stage device ms, device
    busy ms and idle share (against a fourth call's wall)."""
    ms, iters = [], []
    for _ in range(3):
        hist = {}
        ms.append(_warm_ms(torch, lambda: call(hist), 1))
        iters.append(len(hist['labels']))
    stages, busy, n_kernels = _stage_device_ms(torch, lambda: call({}))
    wall = _warm_ms(torch, lambda: call({}), 1)
    per_it = [t / n for t, n in zip(ms, iters)]
    print('%s warm: %s ms in %s iterations, %s ms per iteration (best %.3f); '
          'stage device ms %s; device busy %.3f ms of a %.3f ms call in %d '
          'CUDA kernels, idle share %.4f'
          % (what, ['%.3f' % t for t in ms], iters,
             ['%.3f' % t for t in per_it], min(per_it), json.dumps(
                 {k: round(v, 4) for k, v in stages.items()
                  if k in RG_STAGES}), busy, wall, n_kernels,
             1.0 - busy / wall if wall > 0 else float('nan')), flush=True)


def _grid_invariant(slic, cfg):
    """True when every pixel's label lies within one tile of its own tile
    (the invariant of enforced grid labels)."""
    h, w = slic.shape
    ly, lx = np.divmod(slic, cfg.grid_w)
    ty = (np.arange(h) // cfg.step)[:, None]
    tx = (np.arange(w) // cfg.step)[None, :]
    return bool((np.abs(ly - ty) <= 1).all() and (np.abs(lx - tx) <= 1).all())


def path_rg2sp(torch, scene, fixture, keys=('slic', 'gc_labels', 'gc_iters'),
               what='RG2Sp GraphCut', slic_bar=0.999):
    """BASELINE config 5 on a test scene: SLIC on the card (its enforced
    labels >= ``slic_bar`` equal to JAX's), then GraphCut RG2Sp with the
    JAX-fitted shape model carried across, against the fixture's ``keys``
    (SLIC, labels, iterations); returns (launches, slic, prob)."""
    from pyimsegm_tpu_torch import region_growing as rg
    from pyimsegm_tpu_torch.ops.slic import slic_config
    img, segm, centres = scene
    want_slic, want_labels, want_iters = (fixture[k] for k in keys)
    model = _rg_model(fixture)
    cfg = slic_config(OVARY[0], OVARY[1], RG_SP)
    hist = {}

    def gc(slic, prob, history):
        return rg.region_growing_shape_slic_graphcut(
            slic, prob, centres, model, 'cdf', optim_global=True,
            debug_history=history, grid_cfg=cfg, device=DEVICE, **RG_PARAMS)

    def run():
        slic, prob = _rg_slic(img, segm)
        return slic, prob, gc(slic, prob, hist)

    (slic, prob, labels), launches = _drive(what, PATH_SLIC_ENFORCED, run,
                                            forbidden=WIDE)
    k = int(slic.max()) + 1
    eggs = _egg_masks(segm, centres)
    jax_objs = [np.asarray(want_labels)[want_slic] == i + 1
                for i in range(len(centres))]
    iou_jax = _object_ious(labels, slic, jax_objs)
    true_port = _object_ious(labels, slic, eggs)
    true_jax = _object_ious(want_labels, want_slic, eggs)
    slic_eq = float((slic == want_slic).mean())
    print('%s 647x1024 vs JAX-CPU: kernels observed %s; SLIC labels equal '
          '%.6f (>= %g), K = %d of the grid\'s %d (the %s solve), the '
          '3x3-tile invariant holds %s; %d iterations (JAX %d, within %d); '
          'each egg\'s IoU with JAX\'s object %s (>= %g), with the true egg '
          '%s (JAX %s, at most %g lower)'
          % (what, json.dumps(_observed(launches)), slic_eq, slic_bar, k,
             cfg.n_segments, 'grid' if k == cfg.n_segments else 'edge-list',
             _grid_invariant(slic, cfg), len(hist['labels']), int(want_iters),
             RG_ITER_SLACK, ['%.4f' % v for v in iou_jax], RG_IOU_BAR,
             ['%.4f' % v for v in true_port], ['%.4f' % v for v in true_jax],
             RG_TRUE_SLACK), flush=True)
    if not (slic_eq >= slic_bar and min(iou_jax) >= RG_IOU_BAR
            and abs(len(hist['labels']) - int(want_iters)) <= RG_ITER_SLACK
            and all(p >= j - RG_TRUE_SLACK
                    for p, j in zip(true_port, true_jax))):
        raise AssertionError('%s disagrees with the JAX reference' % what)
    _timed_rg(torch, lambda h: gc(slic, prob, h),
              '%s (cfg5_rg2sp_gc_per_iteration)' % what)
    return launches, slic, prob


def path_rg2sp_greedy(torch, scene, fixture):
    """Greedy RG2Sp: the chain with the SLIC on the card, held to the
    port's CPU greedy on that same SLIC (which equals JAX's on any SLIC
    both are given: ``tests/test_torch_region_growing.py``); then on JAX's
    SLIC, held to JAX's objects and iteration count; returns the launches.

    The greedy stops at its round cap with eggs part grown, so the few
    superpixels in which the card's SLIC differs from JAX's move its
    objects, as they move JAX's: the chain's IoUs with JAX's objects and
    with the true eggs are reported beside JAX's, not held."""
    from pyimsegm_tpu_torch import region_growing as rg
    img, segm, centres = scene
    model = _rg_model(fixture)
    jax_slic = fixture['slic'].astype(np.int32)
    jax_objs = [np.asarray(fixture['greedy_labels'])[jax_slic] == i + 1
                for i in range(len(centres))]

    def greedy(slic, prob, history, mdl=model, device=DEVICE):
        return rg.region_growing_shape_slic_greedy(
            slic, prob, centres, mdl, 'cdf', debug_history=history,
            device=device, **RG_PARAMS)

    chain_hist = {}

    def run():
        slic, prob = _rg_slic(img, segm)
        return slic, prob, greedy(slic, prob, chain_hist)

    (slic, chain_prob, labels), launches = _drive(
        'RG2Sp greedy', PATH_SLIC_ENFORCED, run, forbidden=WIDE)
    ref_hist = {}
    ref = greedy(slic, chain_prob, ref_hist, _rg_model(fixture, 'cpu'), 'cpu')
    iou_ref = _object_ious(labels, slic, [np.asarray(ref)[slic] == i + 1
                                          for i in range(len(centres))])
    iou_chain = _object_ious(labels, slic, jax_objs)
    eggs = _egg_masks(segm, centres)
    true_chain = _object_ious(labels, slic, eggs)
    true_jax = _object_ious(fixture['greedy_labels'], jax_slic, eggs)
    prob = rg.compute_segm_prob_fg(jax_slic, segm, RG_TABLE)
    hist = {}
    labels_j = greedy(jax_slic, prob, hist)
    iou_jax = _object_ious(labels_j, jax_slic, jax_objs)
    iters, want_iters = len(hist['labels']), int(fixture['greedy_iters'])
    print('RG2Sp greedy 647x1024: on the card\'s SLIC against the CPU twin '
          'there labels equal %.6f, %d iterations (CPU %d, within %d), each '
          'egg\'s IoU %s (>= %g); its IoU with the true egg %s (JAX on its '
          'SLIC %s), with JAX\'s object %s; on JAX\'s SLIC vs JAX-CPU labels '
          'equal %.6f, %d iterations (JAX %d, within %d), each egg\'s IoU %s '
          '(>= %g)'
          % (float((labels == ref).mean()), len(chain_hist['labels']),
             len(ref_hist['labels']), RG_ITER_SLACK,
             ['%.4f' % v for v in iou_ref], RG_IOU_BAR,
             ['%.4f' % v for v in true_chain], ['%.4f' % v for v in true_jax],
             ['%.4f' % v for v in iou_chain],
             float((labels_j == fixture['greedy_labels']).mean()), iters,
             want_iters, RG_ITER_SLACK, ['%.4f' % v for v in iou_jax],
             RG_IOU_BAR), flush=True)
    if not (min(iou_ref) >= RG_IOU_BAR and min(iou_jax) >= RG_IOU_BAR
            and abs(len(chain_hist['labels']) - len(ref_hist['labels']))
            <= RG_ITER_SLACK
            and abs(iters - want_iters) <= RG_ITER_SLACK):
        raise AssertionError('greedy RG2Sp disagrees with the reference')
    _timed_rg(torch, lambda h: greedy(jax_slic, prob, h), 'RG2Sp greedy')
    return launches


def path_rg2sp_fitted(torch, scene, fixture):
    """The shape model fitted on the card (rays of the training scenes'
    eggs, mean shift, the variational mixture from a torch.Generator), then
    GraphCut RG2Sp with it: the rays equal to JAX's, as many components as
    JAX's mean shift gave, and each egg's IoU with the true egg no worse
    than JAX's (carried model) by more than RG_TRUE_SLACK; returns the
    launches."""
    from pyimsegm_tpu_torch import region_growing as rg
    from pyimsegm_tpu_torch.ops.slic import slic_config
    from pyimsegm_tpu_torch.utils.data_samples import sample_ovary_scene
    img, segm, centres = scene
    annots = [(sample_ovary_scene(OVARY, N_EGGS, rand_seed=s)[1] > 0)
              .astype(np.int32) for s in RG_SHAPE_SEEDS]
    cfg = slic_config(OVARY[0], OVARY[1], RG_SP)

    def fit():
        rays, _ = rg.compute_object_shapes(
            annots, ray_step=RG_RAY_STEP, smooth_coef=1,
            interp_order='spline', device=DEVICE)
        return rays, rg.transform_rays_model_cdf_mixture(rays, device=DEVICE)

    def run():
        rays, model = fit()
        slic, prob = _rg_slic(img, segm)
        return rays, model, slic, rg.region_growing_shape_slic_graphcut(
            slic, prob, centres, model, 'cdf', optim_global=True,
            grid_cfg=cfg, device=DEVICE, **RG_PARAMS)

    (rays, model, slic, labels), launches = _drive(
        'RG2Sp with the card-fitted shape model', PATH_SLIC_ENFORCED, run,
        forbidden=WIDE)
    eggs = _egg_masks(segm, centres)
    true_port = _object_ious(labels, slic, eggs)
    true_jax = _object_ious(fixture['gc_labels'], fixture['slic'], eggs)
    rays_eq = float((np.asarray(rays) == fixture['rays']).mean())
    table = np.asarray(model[1])
    fit_ms = _warm_ms(torch, fit, 1)
    print('RG2Sp with the card-fitted shape model: rays equal to JAX\'s '
          '%.6f, %d components (JAX %d), table %s finite %s; each egg\'s '
          'IoU with the true egg %s (JAX with its model %s, at most %g '
          'lower); fit ms %.3f (warm)'
          % (rays_eq, len(model[0].weights_), len(fixture['shape_weights']),
             table.shape, bool(np.isfinite(table).all()),
             ['%.4f' % v for v in true_port], ['%.4f' % v for v in true_jax],
             RG_TRUE_SLACK, fit_ms), flush=True)
    if not (rays_eq == 1.0 and np.isfinite(table).all()
            and len(model[0].weights_) == len(fixture['shape_weights'])
            and all(p >= j - RG_TRUE_SLACK
                    for p, j in zip(true_port, true_jax))):
        raise AssertionError('RG2Sp with the card-fitted model falls behind '
                             'the JAX reference')
    return launches


def path_object_graphcuts(torch, scene, fixture, slic):
    """The one-shot object GraphCuts: on the superpixels (object map >=
    0.99 of the pixels equal to JAX's) and on the 662,528 pixels (energy at
    most RG_ENERGY_SLACK above JAX's); returns the launches."""
    from pyimsegm_tpu_torch import region_growing as rg
    from pyimsegm_tpu_torch.ops.graphcut import mrf_energy
    _, segm, centres = scene

    def on_slic():
        return rg.object_segmentation_graphcut_slic(
            slic, segm, centres, labels_fg_prob=RG_TABLE, device=DEVICE,
            **RG_OBJ_SHAPE)

    def on_pixels(debug=None):
        return rg.object_segmentation_graphcut_pixels(
            segm, centres, labels_fg_prob=RG_TABLE, debug_visual=debug,
            device=DEVICE)

    debug = {}
    (obj_slic, obj_px), launches = _drive(
        'object GraphCuts', (), lambda: (on_slic(), on_pixels(debug)))
    slic_eq = float((obj_slic[slic] == fixture['obj_slic_labels'][
        fixture['slic']]).mean())
    c = len(centres) + 1
    unary = torch.as_tensor(np.stack(debug['unary_imgs'], -1).reshape(-1, c),
                            dtype=torch.float32, device=DEVICE)
    edges = torch.as_tensor(rg._grid_edges(*OVARY), device=DEVICE)
    ones = torch.ones(len(edges), device=DEVICE)
    pw = torch.as_tensor(1 - np.eye(c), dtype=torch.float32, device=DEVICE)

    def energy(lab):
        return float(mrf_energy(torch.as_tensor(
            lab.reshape(-1).astype(np.int64), device=DEVICE), unary, edges,
            ones, pw))
    e_port, e_jax = energy(obj_px), float(fixture['obj_px_energy'])
    px_eq = float((obj_px == fixture['obj_px_labels']).mean())
    ms_slic = _warm_ms(torch, on_slic, 1)
    ms_px = [_warm_ms(torch, on_pixels, 1) for _ in range(2)]
    print('object GraphCuts 647x1024 vs JAX-CPU: on the superpixels object '
          'map equal %.6f (>= 0.99), %.3f ms; on the pixels (%d nodes, %d '
          'edges) energy %.3f against JAX\'s %.3f (%+.4f%%, at most %+.1f%%), '
          'JAX\'s labels there %.3f, map equal %.6f, %s ms'
          % (slic_eq, ms_slic, OVARY[0] * OVARY[1], len(edges), e_port,
             e_jax, 100 * (e_port / e_jax - 1), 100 * RG_ENERGY_SLACK,
             energy(fixture['obj_px_labels']), px_eq,
             ['%.3f' % t for t in ms_px]), flush=True)
    if not (slic_eq >= 0.99 and e_port <= e_jax * (1 + RG_ENERGY_SLACK)):
        raise AssertionError('an object GraphCut disagrees with the JAX '
                             'reference')
    return launches


def path_compat(torch, scene, fixture):
    """The skimage-compat SLIC (raw labels >= COMPAT_RAW_BAR of the pixels
    equal to JAX's), its host postprocess (exact on JAX's raw labels) and
    ``sp_compat`` with the JAX-fitted class model (ARS >= COMPAT_ARS_BAR);
    returns the launches."""
    from pyimsegm_tpu_torch import pipelines
    from pyimsegm_tpu_torch.models.class_model import class_model_from_numpy
    from pyimsegm_tpu_torch.ops import slic as slic_ops
    from pyimsegm_tpu_torch.ops.connectivity_host import enforce_connectivity
    from pyimsegm_tpu_torch.utils.metrics import adjusted_rand_score
    img, _, _ = scene
    cfg = slic_ops.slic_config(OVARY[0], OVARY[1], RG_SP)
    m = slic_ops.compactness_from_regul(RG_SP, RG_REGUL)
    model = class_model_from_numpy({k[len('compat_model_'):]: v
                                    for k, v in fixture.items()
                                    if k.startswith('compat_model_')}).to(
                                        DEVICE)
    img_t = torch.as_tensor(img, device=DEVICE)

    def raw():
        return slic_ops._slic_segment_skimage(img_t, cfg, m)

    def segment():
        return pipelines.segment_color2d_slic_features_model_graphcut(
            img, model, FEATURES, sp_size=RG_SP, sp_regul=RG_REGUL,
            gc_regul=GC_REGUL, sp_compat=True)

    (labels, (segm, soft)), launches = _drive(
        'compat SLIC and sp_compat', (), lambda: (raw(), segment()))
    raw_eq = float((labels.cpu().numpy() == fixture['compat_raw']).mean())
    min_size = int(0.5 * cfg.step * cfg.step)
    t0 = time.perf_counter()
    enforced = enforce_connectivity(fixture['compat_raw'].astype(np.int32),
                                    min_size)
    host_ms = (time.perf_counter() - t0) * 1e3
    exact = bool(np.array_equal(enforced, fixture['compat_enforced']))
    ars = adjusted_rand_score(segm, fixture['compat_segm'])
    raw_ms = _time_ms(raw, reps=3)
    full_ms = _warm_ms(torch, lambda: slic_ops.segment_slic_img2d(
        img_t, sp_size=RG_SP, relative_compact=RG_REGUL, compat=True), 1)
    seg_ms = _warm_ms(torch, segment, 1)
    print('compat SLIC 647x1024 vs JAX-CPU: raw labels equal %.6f (>= %g), '
          '%.3f device ms (25 offsets x 10 rounds of eager passes); the host '
          'postprocess exact on JAX\'s raw labels %s, %d labels, %.1f ms; '
          'segment_slic_img2d(compat=True) %.3f ms; sp_compat ARS %.6f (>= '
          '%g), soft finite %s, %.3f ms'
          % (raw_eq, COMPAT_RAW_BAR, raw_ms, exact, int(enforced.max()) + 1,
             host_ms, full_ms, ars, COMPAT_ARS_BAR,
             bool(np.isfinite(soft).all()), seg_ms), flush=True)
    if not (raw_eq >= COMPAT_RAW_BAR and exact and ars >= COMPAT_ARS_BAR
            and np.isfinite(soft).all()):
        raise AssertionError('the compat SLIC disagrees with the JAX '
                             'reference')
    return launches


#: phase 14, the ovary zoo after its SLIC (apps/run_ovary_egg_segmentation.py):
#: the zoo's slic_size and slic_regul, the snakes' circle radius and
#: iteration cap, and (smoothing, lambdas) of its two morph-snakes methods
FIXTURE_REST = os.path.join(ROOT, 'tests', 'data',
                            'torch_port_fixture_rest.npz')
REST_SP, REST_REGUL, REST_SEED = 40, 0.3, CENTER_TEST_SEED
SNAKE_RADIUS, SNAKE_MAX_ITER = 15, 300
SNAKES = {'morph-snakes_img': (5, (3., 3.)), 'morph-snakes_seg': (3, (2., 1.))}
#: bars of a snake label map against JAX's: equal pixels, each object's IoU
SNAKE_BAR, SNAKE_IOU_BAR = 0.999, 0.99
#: the iterations of the snakes' CPU run, held against the card's run cut
#: to the same count (the port's CPU loop takes ~0.3 s an iteration here)
SNAKE_CPU_ITER = 20
#: the annotation check's perturbed share of pixels and its seed
ANNOT_PERTURB, ANNOT_SEED = 0.05, 0
INVERSE_SPACES = ('xyz', 'lab', 'luv', 'hsv', 'hed')
#: bars of the descriptor API on the card against the host float64 numpy
#: twins: rtol + atol, and for the std an absolute bar, since
#: sqrt(E[v^2] - E[v]^2) from f32 sums of ~1,600 pixels cancels to ~5e-5
#: (the port's CPU run, and JAX's, share this f32 limit)
DESC_RTOL, DESC_ATOL, DESC_STD_ATOL = 1e-5, 1e-6, 2e-4


def simplify_segm_3cls(seg, lut=(0., 0.8, 1.), smooth=True):
    """The ovary zoo's collapse of a class map into 3 smoothed intensity
    levels with the holes filled (a copy of the app's, host scipy)."""
    from scipy import ndimage
    seg = np.asarray(seg)
    segm = seg.copy()
    segm[seg > 1] = 2
    if np.sum(seg > 0) > 0:
        filled = ndimage.binary_fill_holes(seg > 0)
        segm[np.logical_and(seg == 0, filled)] = 2
    segm = np.array(lut)[segm]
    if smooth:
        segm = ndimage.gaussian_filter(segm, 5)
    return segm


def snake_call(method, img, segm, centres):
    """(image (H, W), circle masks, n_iter, smoothing, lambdas) of one of
    the zoo's morph-snakes methods, as it calls them."""
    from pyimsegm_tpu_torch.ops.snakes import circle_masks
    smoothing, lambdas = SNAKES[method]
    image = simplify_segm_3cls(segm) if method == 'morph-snakes_seg' else img
    image = np.asarray(image, float)
    if image.ndim == 3:
        image = image[:, :, 0]
    n_iter = min(int(np.hypot(*image.shape) / 2.0), SNAKE_MAX_ITER)
    return (image, circle_masks(image.shape, centres, radius=SNAKE_RADIUS),
            n_iter, smoothing, lambdas)


def annotation_image(segm, seed=ANNOT_SEED, perturb=ANNOT_PERTURB):
    """The class map in ``annotation.DICT_COLOURS``, ``perturb`` of its
    pixels moved by up to +-60 per channel (uint8)."""
    from pyimsegm_tpu_torch.annotation import DICT_COLOURS
    img = np.asarray(list(DICT_COLOURS.values()), np.int32)[segm]
    rng = np.random.default_rng(seed)
    hit = rng.random(segm.shape) < perturb
    img[hit] += rng.integers(-60, 61, (int(hit.sum()), 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def _snake_ious(got, want, n):
    return [float(((got == lb) & (want == lb)).sum()
                  / max(((got == lb) | (want == lb)).sum(), 1))
            for lb in range(1, n + 1)]


def path_snakes(torch, scene, fixture):
    """The zoo's two morph-snakes methods on the card against JAX-CPU's
    label maps and the port's CPU run (cut to ``SNAKE_CPU_ITER``
    iterations), then warm ms per call (host clock and
    ``utils.profiling.time_jitted``), CUDA kernels per call and idle
    share; returns the card's label maps."""
    from pyimsegm_tpu_torch.ops import snakes
    from pyimsegm_tpu_torch.utils.profiling import time_jitted
    img, segm, centres = scene
    out = {}
    for method in SNAKES:
        image, masks, n_iter, smoothing, lambdas = snake_call(
            method, img, segm, centres)
        image_t = torch.as_tensor(image, dtype=torch.float32, device=DEVICE)
        masks_t = torch.as_tensor(masks, device=DEVICE)

        def run(n=n_iter, dev_img=image_t, dev_masks=masks_t):
            return snakes.morph_acwe_multi(dev_img, dev_masks, n_iter=n,
                                           smoothing=smoothing,
                                           lambda1=lambdas[0],
                                           lambda2=lambdas[1])

        labels = run().cpu().numpy()
        want = fixture[method.replace('-', '_')].astype(np.int32)
        equal = float((labels == want).mean())
        ious = _snake_ious(labels, want, len(centres))
        short = run(SNAKE_CPU_ITER).cpu().numpy()
        short_cpu = snakes.morph_acwe_multi(
            image, masks, n_iter=SNAKE_CPU_ITER, smoothing=smoothing,
            lambda1=lambdas[0], lambda2=lambdas[1], device='cpu').numpy()
        equal_cpu = float((short == short_cpu).mean())
        ms = [_warm_ms(torch, run, 1) for _ in range(3)]
        ev_ms = time_jitted(run, reps=3) * 1e3
        _, busy, n_kernels = _stage_device_ms(torch, run)
        wall = _warm_ms(torch, run, 1)
        print('%s 647x1024, %d objects, %d iterations, smoothing %d, lambdas '
              '%s: labels equal to JAX-CPU\'s %.6f (>= %g), each object\'s '
              'IoU %s (>= %g); at %d iterations equal to the port\'s CPU run '
              '%.6f (>= %g); warm %s ms per call (host clock), %.3f ms '
              '(utils.profiling.time_jitted, CUDA events); device busy %.3f '
              'ms of a %.3f ms call in %d CUDA kernels (%.1f per iteration), '
              'idle share %.4f'
              % (method, len(centres), n_iter, smoothing, list(lambdas),
                 equal, SNAKE_BAR, ['%.4f' % v for v in ious], SNAKE_IOU_BAR,
                 SNAKE_CPU_ITER, equal_cpu, SNAKE_BAR,
                 ['%.3f' % t for t in ms], ev_ms, busy, wall, n_kernels,
                 n_kernels / n_iter, 1.0 - busy / wall), flush=True)
        if not (equal >= SNAKE_BAR and min(ious) >= SNAKE_IOU_BAR
                and equal_cpu >= SNAKE_BAR):
            raise AssertionError('%s disagrees with the reference' % method)
        out[method] = labels
    return out


def check_descriptor_api(torch, img, slic):
    """The descriptor API on the card's SLIC labels against the host numpy
    twins on the same labels (and the median and meanGrad against the
    port's CPU run)."""
    from pyimsegm_tpu_torch import descriptors as desc
    labels = torch.as_tensor(slic, device=DEVICE)
    flags = desc.NAMES_FEATURE_FLAGS
    feats, names = desc.compute_image2d_color_statistic(img, labels, flags,
                                                        device=DEVICE)
    cpu, _ = desc.compute_image2d_color_statistic(img, slic, flags,
                                                  device='cpu')
    twins = {'mean': desc.numpy_img2d_color_mean(img, slic),
             'std': desc.numpy_img2d_color_std(img, slic),
             'energy': desc.numpy_img2d_color_energy(img, slic),
             'median': desc.numpy_img2d_color_median(img, slic)}
    errs = {}
    for i, flag in enumerate(flags):
        block = feats[:, 3 * i:3 * i + 3]
        if flag in twins:
            np.testing.assert_allclose(
                block, twins[flag], rtol=DESC_RTOL, err_msg=flag,
                atol=DESC_STD_ATOL if flag == 'std' else DESC_ATOL)
            errs[flag] = float(np.abs(block - twins[flag]).max())
    np.testing.assert_array_equal(feats[:, 9:12], cpu[:, 9:12])
    np.testing.assert_allclose(feats[:, 12:], cpu[:, 12:], rtol=DESC_RTOL,
                               atol=DESC_ATOL)
    for stat in ('mean', 'std', 'energy'):
        got = getattr(desc, 'cython_img2d_color_' + stat)(img, labels)
        np.testing.assert_allclose(
            got, twins[stat], rtol=DESC_RTOL, err_msg=stat,
            atol=DESC_STD_ATOL if stat == 'std' else DESC_ATOL)
    print('descriptor API on the card\'s SLIC labels, K = %d, %d features: '
          'against the numpy twins within %s (rtol %g + atol %g, the std '
          'atol %g), median equal to the port\'s CPU run, cython_* mean / '
          'std / energy within the same bars'
          % (feats.shape[0], len(names), json.dumps(
              {k: float('%.3g' % v) for k, v in errs.items()}), DESC_RTOL,
              DESC_ATOL, DESC_STD_ATOL), flush=True)


def check_colour_inverses(torch):
    """Each inverse at 884x1200 on the card against the port's CPU run on
    the same input, and the round trip sRGB -> space -> sRGB."""
    from pyimsegm_tpu_torch.ops import color
    from pyimsegm_tpu_torch.utils.data_samples import \
        sample_color_image_rand_segment
    rgb = torch.as_tensor(sample_color_image_rand_segment(CROP, 3,
                                                          rand_seed=0)[0],
                          device=DEVICE)
    errs = {}
    for space in INVERSE_SPACES:
        src = color.convert_img_color_from_rgb(rgb, space)
        back = color.convert_img_color_to_rgb(src, space)
        cpu = color.convert_img_color_to_rgb(src.cpu(), space)
        err = float((back.cpu() - cpu).abs().max())
        trip = float((back - rgb).abs().max())
        errs[space] = (err, trip)
        if not (err <= 1e-5 and trip <= 1e-4):
            raise AssertionError('%s inverse: %g from the CPU run, round trip '
                                 '%g' % (space, err, trip))
    print('colour inverses at 884x1200 on the card: (max |card - CPU|, max '
          'round-trip error) %s (<= 1e-5, <= 1e-4)' % json.dumps(
              {k: ['%.3g' % e for e in v] for k, v in errs.items()}),
          flush=True)


def check_annotation(torch, segm, fixture):
    """The nearest-colour quantisation of the perturbed annotation on the
    card, exactly JAX-CPU's indices."""
    from pyimsegm_tpu_torch import annotation
    palette = list(annotation.DICT_COLOURS.values())
    img = annotation_image(segm)
    want = fixture['quant'].astype(np.int64)
    idx = annotation.image_color_2_labels(torch.as_tensor(img, device=DEVICE),
                                          palette)
    quant = annotation.quantize_image_nearest_color(img, palette,
                                                    device=DEVICE)
    if not (np.array_equal(idx, want)
            and np.array_equal(quant, np.asarray(palette, np.uint8)[want])):
        raise AssertionError('quantisation: %d indices differ from JAX\'s'
                             % int((idx != want).sum()))
    print('annotation quantisation 647x1024 (%.4f of the pixels perturbed): '
          'indices equal to JAX-CPU\'s, %d pixels off their class colour'
          % (ANNOT_PERTURB, int((want != segm).sum())), flush=True)


def check_labeling(torch, segm, slic, snake_labels):
    """The label-map functions on the card's outputs (as tensors on the
    card) exactly equal to the same host calls on their numpy copies."""
    from pyimsegm_tpu_torch import labeling
    card = torch.as_tensor(slic, device=DEVICE)
    calls = {
        'compute_boundary_distances': lambda s: labeling.
        compute_boundary_distances(segm, s),
        'assume_bg_on_boundary': labeling.assume_bg_on_boundary,
        'relabel_max_overlap_merge': lambda s: labeling.
        relabel_max_overlap_merge(segm, s),
    }
    for name, call in calls.items():
        for labels in [slic] + list(snake_labels.values()):
            got = call(torch.as_tensor(labels, device=DEVICE))
            want = call(np.asarray(labels))
            for g, w in zip(got if isinstance(got, tuple) else (got,),
                            want if isinstance(want, tuple) else (want,)):
                np.testing.assert_array_equal(g, w, err_msg=name)
    points, dist = labeling.compute_boundary_distances(segm, card)
    print('labeling on the card\'s SLIC and snake labels: %s exact; %d '
          'class-boundary pixels, mean distance to a superpixel boundary '
          '%.4f px' % (sorted(calls), len(points), float(dist.mean())),
          flush=True)


def path_rest(torch, scene, fixture):
    """Phase 14: the ovary zoo's SLIC on the card (rows 1, 2, 4, 7, 9, 10
    and 12), its snakes, the descriptor API, colour inverses, annotation
    quantisation and label-map functions; returns the SLIC's launches."""
    from pyimsegm_tpu_torch import superpixels
    img, segm, _ = scene
    slic, launches = _drive('ovary zoo SLIC', PATH_SLIC_ENFORCED,
                            lambda: superpixels.segment_slic_img2d(
                                img, sp_size=REST_SP,
                                relative_compact=REST_REGUL, device=DEVICE))
    equal = float((slic == fixture['slic']).mean())
    print('ovary zoo SLIC 647x1024 at sp_size %d, regul %g: K = %d, labels '
          'equal to JAX-CPU\'s %.6f (>= 0.999)'
          % (REST_SP, REST_REGUL, int(slic.max()) + 1, equal), flush=True)
    if equal < 0.999:
        raise AssertionError('the zoo SLIC disagrees with JAX')
    snake_labels = path_snakes(torch, scene, fixture)
    check_descriptor_api(torch, img, slic)
    check_colour_inverses(torch)
    check_annotation(torch, segm, fixture)
    check_labeling(torch, segm, slic, snake_labels)
    return launches


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 1
    gpu = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True).stdout.strip()
    print(gpu, flush=True)
    sys.path.insert(0, ROOT)
    from pyimsegm_tpu_torch import _build
    from pyimsegm_tpu_torch.models.class_model import class_model_from_numpy
    from pyimsegm_tpu_torch.ops import (connectivity_cuda, enforce_cuda,
                                        grid_cuda, prep_cuda, slic3d_cuda,
                                        slic_cuda)
    from pyimsegm_tpu_torch.utils.data_samples import (
        sample_color_image_rand_segment, sample_gray_volume_3d)

    t0 = time.perf_counter()
    _build.build(LIBRARIES)
    for mod in (prep_cuda, slic_cuda, grid_cuda, enforce_cuda, slic3d_cuda,
                connectivity_cuda):
        mod._lib()
    print('build: %.2f s total, per library %s'
          % (time.perf_counter() - t0, json.dumps(_build.BUILD_SECONDS)),
          flush=True)

    fixtures = []
    for path in (FIXTURE, FIXTURE_CONN, FIXTURE_FIT, FIXTURE_3D, FIXTURE_SUP,
                 FIXTURE_NOISE, FIXTURE_CLF, FIXTURE_3D_TLM, FIXTURE_CENTERS,
                 FIXTURE_RG2SP, FIXTURE_REST):
        with np.load(path) as npz:
            fixtures.append({k: npz[k] for k in npz.files})
    pairs = [sample_color_image_rand_segment(CROP, 3, rand_seed=s)
             for s in range(BATCH)]
    images = [p[0] for p in pairs]
    img = torch.as_tensor(images[0], device=DEVICE)
    records = kernel_phases(torch, img)
    prep_phases(torch, img)
    minsize_count_phases(torch, img)
    enforce_cases(torch)
    odd_geometry_phases(torch)
    measure_path_kernels(torch, img)
    records += fit_kernel_phases(torch, img)
    reduce_phases(torch)
    step_phases(torch)
    big_step_3d_phases(torch)
    model = class_model_from_numpy(fixtures[0]).to(DEVICE)
    path_connectivity_false(torch, model, images, fixtures[0])
    bench = path_bench(torch, model, images, fixtures[1])
    path_noise(torch, model, fixtures[5])
    op = path_enforce_op(torch, img)
    fit = path_fit(torch, images, fixtures[2])

    vol = torch.as_tensor(sample_gray_volume_3d(SHAPE_3D)[0], device=DEVICE)
    rng = np.random.default_rng(0)                # bench_all.py's cfg6 volume
    noise = rng.random(SHAPE_3D, dtype=np.float32) / 2.0
    noise[:, :, :SHAPE_3D[2] // 2] += 0.5
    records += kernel_phases_3d(torch, vol, torch.as_tensor(noise,
                                                             device=DEVICE))
    fixture_3d = {k: v for k, v in fixtures[3].items()
                  if not k.startswith('small_')}
    gray3d = path_gray3d(torch, vol, fixture_3d)
    path_gray3d_tlm(torch, fixtures[7])

    records += kernel_phases_wide(torch)
    records += row7_phases(torch, img)
    sup = path_supervised(torch, images, fixtures[4])
    clf = path_train(torch, images, [p[1] for p in pairs], fixtures[4])
    tiles = path_tiles(torch, clf)
    path_families(torch, images, fixtures[6])
    path_train_families(torch, images, [p[1] for p in pairs], fixtures[6])
    big_step_8_phase(torch)
    scenes = _ovary_scenes()
    slice_kernel_phases(torch, scenes[-1])
    centre_paths = (path_centers(torch, scenes, fixtures[8]),
                    path_train_centers(torch, scenes, fixtures[8]),
                    path_ellipses(torch, scenes, fixtures[8]))
    slice_kernel_phases(torch, scenes[-1], cases=(
        ('colour scene, sp_size 15', 'colour', RG_SP, RG_REGUL),))
    rg_launches, rg_slic, _ = path_rg2sp(torch, scenes[-1], fixtures[9])
    from pyimsegm_tpu_torch.utils.data_samples import sample_ovary_scene
    grid_launches = path_rg2sp(
        torch, sample_ovary_scene(OVARY, N_EGGS, rand_seed=RG_GRID_SEED),
        fixtures[9], keys=('grid_slic', 'grid_labels', 'grid_iters'),
        what='RG2Sp GraphCut, grid route', slic_bar=NOISE_ENFORCED_BAR)[0]
    centre_paths += (rg_launches, grid_launches,
                     path_rg2sp_greedy(torch, scenes[-1], fixtures[9]),
                     path_rg2sp_fitted(torch, scenes[-1], fixtures[9]),
                     path_object_graphcuts(torch, scenes[-1], fixtures[9],
                                           rg_slic),
                     path_compat(torch, scenes[-1], fixtures[9]),
                     path_rest(torch, scenes[-1], fixtures[10]))
    for rec in records:
        name = rec['name']
        rec['launches'] = (
            tiles[TILE_14][name] if name == 'reach_absorb_fused' else
            tiles[TILE_13][name] if name in ('reach_absorb', 'anchor_seed')
            else sup['grid_moments'] if name.startswith('grid_moments_f')
            else bench[name] if name in PATH_BENCH else
            op[name] if name in PATH_OP else
            gray3d[name] if name in PATH_3D + PASSES_3D else fit[name])
        if name in PATH_CENTERS:
            rec['launches'] += sum(p[name] for p in centre_paths)
    print('host packages on this machine: %s' % json.dumps(
        {m: importlib.util.find_spec(m) is not None
         for m in ('scipy', 'pandas', 'PIL', 'matplotlib', 'yaml')}),
        flush=True)
    print(json.dumps({'kernels': records}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
