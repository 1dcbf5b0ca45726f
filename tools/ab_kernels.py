"""Same-call A/B of build variants of kernel rows 1-8, 10, 11 and 15.

A variant is ``base`` (the source as it is), ``KEY=V+KEY=V`` (each KEY
names a constant of the kernel's source, and the variant is built from a
copy of the source with that constant set to V; the tool fails if the
constant's definition is not found once) or the path of a ``.cu`` file,
built as it is in the source's place (an earlier or an edited copy of the
source, for a change that no constant names).

``--kernel schedule`` (row 2, the cooperative SLIC schedule of
``pyimsegm_tpu_torch/csrc/slic.cu``): the members of ``Sched<SLICO>``, per
mode, ``THREADS`` / ``THREADS_SLICO`` (block size, ``T``), ``MIN_BLOCKS`` /
``MIN_BLOCKS_SLICO`` (blocks an SM must hold, which caps the registers) and
``PRUNE`` / ``PRUNE_SLICO`` (own seed first, and skip a candidate's colour
term when its spatial term alone exceeds the best).  On the bench geometry
(884x1200, sp_size 35, regul 0.2), for image 0 of
``sample_color_image_rand_segment`` and ``bench.py``'s first noise image,
it times one 9-round schedule of each variant, plain and SLICO, and holds
its centres against the plain twin (within 1e-3).

``--kernel assign`` (rows 3-5, the single assignment pass of
``csrc/slic.cu``): the members of ``Pass<CH, SLICO>``, ``T_FEAT`` (block
size with the 12 feature-moment channels, row 3) and ``T_PLAIN`` (the other
modes).  On the bench geometry, for image 0 and the first noise image, from
the centres of a 9-round schedule, it times row 3 (labels, partials with
the image's moments and the routed sums: pass + route), row 4 (labels
only) and row 5 (partials only), holding labels exact and partials and sums
within rtol 1e-5 + 1e-5 x channel max against the plain twin.

``--kernel slic3d`` (row 15, the cooperative 3D SLIC of
``csrc/slic3d.cu``): the members of ``Cfg3``, ``THREADS`` (``T``) and
``MIN_BLOCKS``.  At the 3D workload (48x640x768, spacing
(4, 1, 1), sp_size 15, regul 0.2) on the structured volume of
``sample_gray_volume_3d``, it times the 10-iteration schedule, the labels
pass and the partials pass, holding the passes to their twins (labels
exact, partials within rtol 1e-5 + 1e-5 x channel max) and the schedule's
labels to the twin's (>= 0.999).

``--kernel moments`` (row 8, the donor apply + moments of
``csrc/grid.cu``): ``MOM_THREADS`` (block size).  It times
``grid_moments_apply`` on the enforced SLIC kernels' labels of image 0 with
the min-size donor table of the bench path, and with a donor table of
random seeds within one grid cell (most pixels merge), holding merged
labels exact and sums within rtol 1e-5 against the plain twin.

``--kernel reduce`` (rows 6 and 7, the per-superpixel reduce of
``csrc/grid.cu``): ``RED_THREADS`` (block size), ``RED_MIN_BLOCKS``
(blocks an SM must hold, which caps the registers) and ``RED_LABELS_STEP``
(labels a block reads before it codes them).  On the SLIC kernels' labels
of image 0 at the bench geometry it times row 6 at F = 7 (f32 and bf16),
the paths' F = 4 (f32) and 30 (bf16), and row 7 at F = 3, 18 and 60,
holding the sums within rtol 1e-5 + 1e-5 x channel max against the plain
twins, and prints each variant's device us per CUDA kernel.

``--kernel prep`` (row 1, the min / max + blur + Lab of
``csrc/prep.cu``): ``PREP_TW``, ``PREP_TH`` (output tile), ``PREP_S`` (rows
of a thread's vertical strip), ``PREP_THREADS``, ``PREP_MIN_BLOCKS``,
``PREP_TW_WIDE``, ``PREP_WIDE_PIXELS`` and ``MM_THREADS``.  It first runs
the exhaustive division check: one launch per constant divisor of the Lab
forms (1.055, 12.92, 0.95047, 1.08883, 3 and 3 (6/29)^2) over all 2^32 f32
inputs, comparing the bits of a three-FMA form by the rounded reciprocal
(``div_fma`` of ``DIV_CHECK``) with ``__fdiv_rn``'s, and prints the
mismatches of each (a divisor may take the form only where there are
none).  Then it times
``blur_lab`` on image 0 at 884x1200, at 883x1197 and on a 4096x4096 tile,
holding the bf16 planes to the twin (>= 0.9999 equal, at most 1 ulp).

``--kernel pair`` (row 10, the pair count and its route in
``csrc/grid.cu``): ``PAIR_THREADS``, ``PAIR_STAGE`` and ``PAIR_LOADS``.
On the enforced SLIC kernels' labels of image 0 and of ``bench.py``'s first
noise image at 884x1200 it times the routed call (``counts_and_contacts``'s
triple), holding it and (cnt9, counts9) exactly equal to the twins.

``--kernel adj`` (row 11, the presence pass, row 10's pass in its
presence mode, and its route in ``csrc/grid.cu``): the same constants.  On
the SLIC kernels' labels and the enforced labels of image 0 and of the
first noise image at 884x1200 it times the routed call (``grid_adjacency``),
holding its words and its adjacency exactly equal to the twins.

``--sass`` prints, for each variant, the SASS instruction count of each
kernel of the source (``cuobjdump --dump-sass``), whole and split at its
block barriers (``BAR.SYNC``), and stops before any launch.

``--kernel slic3d --probe`` measures where row 15's pass spends a tile
instead: a copy whose blocks add, per work item, the ``clock64`` cycles of
each phase (waiting for the item's copies, building the tile's tables,
evaluating the voxels, storing the labels or reducing the sums) to device
counters, read after one labels pass and one partials pass; and a
timing-only copy that
evaluates 1 of the 27 candidates (its labels are wrong), timed in turns
with the source as it is.

Each variant is built with ``nvcc -Xptxas -v``, all started together, and
its registers and spills are printed.  Times: CUDA events around 20 calls,
variants in turns (in order, then reversed).

Run from the root of a checkout on a machine with a CUDA card::

    python3 tools/ab_kernels.py \\
        --kernel schedule|moments|assign|slic3d|reduce|prep|pair|adj \\
        [--variants base,PRUNE=1,...] [--probe] [--sass]
"""

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CROP = (884, 1200)
SP_SIZE, SP_REGUL = 35, 0.2
REPS = 20
#: per kernel: (source, kernel name in the ptxas log, default variants)
KERNELS = {
    'schedule': ('slic', 'slic_schedule_kernel',
                 'base,PRUNE=1+PRUNE_SLICO=0,THREADS_SLICO=96+'
                 'MIN_BLOCKS_SLICO=8'),
    'moments': ('grid', 'grid_moments_kernel',
                'base,MOM_THREADS=64,MOM_THREADS=128'),
    'assign': ('slic', 'slic_pass_kernel',
               'base,T_FEAT=32,T_PLAIN=64,T_FEAT=32+T_PLAIN=64'),
    'slic3d': ('slic3d', 'slic3d_kernel',
               'base,THREADS=64,MIN_BLOCKS=8'),
    'reduce': ('grid', 'grid_reduce_kernel',
               'base,RED_THREADS=64,RED_MIN_BLOCKS=1'),
    'prep': ('prep', 'blur_lab_kernel', 'base,PREP_S=16,PREP_TH=64'),
    'pair': ('grid', 'grid_pair_kernel', 'base,PAIR_THREADS=128'),
    'adj': ('grid', 'grid_pair_kernel', 'base,PAIR_LOADS=1,PAIR_LOADS=8,'
            'PAIR_THREADS=128'),
}
#: row 1's exhaustive check of an FMA form of its constant divisions: one
#: launch per constant divisor of csrc/prep.cu over every f32 bit pattern
DIV_CHECK = r'''
#include <cuda_runtime.h>

// the Lab forms' constant divisors, in the f32 rounding of csrc/prep.cu
__host__ __device__ constexpr float divisor(int i) {
    return i == 0 ? 1.055f
         : i == 1 ? 12.92f
         : i == 2 ? 0.95047f
         : i == 3 ? 1.08883f
         : i == 4 ? 3.0f
         : (float)(3.0 * (6.0 / 29.0) * (6.0 / 29.0));
}

// x / c as q = x * r, e = x - q * c (exact by the FMA), q + e * r rounded
// once, r = 1 / c rounded; |x| outside [2^-100, 2^100], zeros, infinities
// and NaNs by __fdiv_rn
__device__ __forceinline__ float div_fma(float x, float c, float r) {
    const unsigned int ax = __float_as_uint(x) & 0x7fffffffu;
    if (ax - 0x0d800000u >= 0x64000000u) return __fdiv_rn(x, c);
    const float q = __fmul_rn(x, r);
    return __fmaf_rn(__fmaf_rn(-q, c, x), r, q);
}

template <int I>
__global__ void div_check_kernel(unsigned long long* bad, unsigned int* first) {
    unsigned long long n = 0;
    unsigned int f = 0xffffffffu;
    const unsigned long long stride = (unsigned long long)gridDim.x * blockDim.x;
    for (unsigned long long i = (unsigned long long)blockIdx.x * blockDim.x
             + threadIdx.x; i < (1ull << 32); i += stride) {
        const float x = __uint_as_float((unsigned int)i);
        if (__float_as_uint(div_fma(x, divisor(I), 1.0f / divisor(I)))
                != __float_as_uint(__fdiv_rn(x, divisor(I)))) {
            ++n;
            f = min(f, (unsigned int)i);
        }
    }
    if (n) {
        atomicAdd(bad + I, n);
        atomicMin(first + I, f);
    }
}

extern "C" int prep_div_check(void* bad, void* first, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    unsigned long long* b = (unsigned long long*)bad;
    unsigned int* f = (unsigned int*)first;
    div_check_kernel<0><<<1056, 256, 0, st>>>(b, f);
    div_check_kernel<1><<<1056, 256, 0, st>>>(b, f);
    div_check_kernel<2><<<1056, 256, 0, st>>>(b, f);
    div_check_kernel<3><<<1056, 256, 0, st>>>(b, f);
    div_check_kernel<4><<<1056, 256, 0, st>>>(b, f);
    div_check_kernel<5><<<1056, 256, 0, st>>>(b, f);
    return (int)cudaGetLastError();
}
'''
DIVISORS = ('1.055', '12.92', '0.95047', '1.08883', '3', '3 (6/29)^2')
#: plain members of a struct, by key: (source file, member)
MEMBERS = {'assign': {'T_FEAT': 'T_FEAT', 'T_PLAIN': 'T_PLAIN'},
           'slic3d': {'THREADS': 'T', 'MIN_BLOCKS': 'MIN_BLOCKS'}}
#: the schedule's keys: member of Sched<SLICO>, by key without _SLICO
SCHED_MEMBERS = {'THREADS': 'T', 'MIN_BLOCKS': 'MIN_BLOCKS',
                 'PRUNE': 'PRUNE'}


#: row 15's probe copies: (text of the source, replacement) edits, by name
_PHASE = ('atomicAdd(&probe[%d], (unsigned long long)(t%d - t%d));')
PROBES = {
    'one_candidate': [('if (o < NOFF)', 'if (o < 1)')],
    'phases': [
        ('struct Smem3 {', '__device__ unsigned long long probe[5];\n'
         'extern "C" int slic3d_probe(void* out, int reset) {\n'
         '    static const unsigned long long zero[5] = {0, 0, 0, 0, 0};\n'
         '    return (int)(reset ? cudaMemcpyToSymbol(probe, zero, 40)\n'
         '                       : cudaMemcpyFromSymbol(out, probe, 40));\n'
         '}\n\nstruct Smem3 {'),
        ('    while (t < n_tiles) {\n',
         '    while (t < n_tiles) {\n        long long t0 = clock64();\n'),
        ('        copy_wait_prior();\n        __syncthreads();\n',
         '        copy_wait_prior();\n        __syncthreads();\n'
         '        long long t1 = clock64(), t2 = t1;\n'),
        ('            build_tables(a, m, t, b);\n            __syncthreads();\n',
         '            build_tables(a, m, t, b);\n            __syncthreads();\n'
         '            t2 = clock64();\n'),
        ('        __syncthreads();\n        if (!POOL) {\n',
         '        __syncthreads();\n        long long t3 = clock64();\n'
         '        if (!POOL) {\n'),
        ('        t = tn;\n        r0 = rn;\n',
         '        long long t4 = clock64();\n        if (tid == 0) {\n'
         + ''.join('            ' + _PHASE % (i, i + 1, i) + '\n'
                   for i in range(4))
         + '            atomicAdd(&probe[4], 1ull);\n        }\n'
         '        t = tn;\n        r0 = rn;\n')],
}


def _sub_once(pattern, repl, text, key):
    text, n = re.subn(pattern, repl, text)
    if n != 1:
        raise SystemExit('ab_kernels: %s: %d definitions found, need 1'
                         % (key, n))
    return text


def _variant_source(kernel, variant, text):
    """The source text of ``variant``."""
    if variant == 'base':
        return text
    if variant.endswith('.cu'):
        with open(variant) as f:
            return f.read()
    if variant in PROBES:
        for old, new in PROBES[variant]:
            if text.count(old) != 1:
                raise SystemExit('ab_kernels: probe %s: %d places found for '
                                 '%r, need 1' % (variant, text.count(old),
                                                 old))
            text = text.replace(old, new)
        return text
    sets = dict(kv.split('=') for kv in variant.split('+'))
    if kernel in ('moments', 'reduce', 'prep', 'pair', 'adj'):
        for key, v in sets.items():
            text = _sub_once(r'#define %s \S+' % re.escape(key),
                             '#define %s %s' % (key, v), text, key)
        return text
    if kernel in MEMBERS:
        for key, v in sets.items():
            if key not in MEMBERS[kernel]:
                raise SystemExit('ab_kernels: unknown key %s' % key)
            text = _sub_once(
                r'(static constexpr \w+ %s = )[^;]+;' % MEMBERS[kernel][key],
                r'\g<1>%s;' % v, text, key)
        return text
    for key, member in SCHED_MEMBERS.items():
        plain, slico = sets.pop(key, None), sets.pop(key + '_SLICO', None)
        if plain is None and slico is None:
            continue
        pat = r'(static constexpr \w+ %s = )([^;]+);' % member

        def repl(m, plain=plain, slico=slico):
            expr = m.group(2)
            return '%sSLICO ? (%s) : (%s);' % (
                m.group(1),
                slico if slico is not None else re.sub(r'\bSLICO\b',
                                                       'true', expr),
                plain if plain is not None else re.sub(r'\bSLICO\b',
                                                       'false', expr))
        text = _sub_once(pat, repl, text, key)
    if sets:
        raise SystemExit('ab_kernels: unknown keys %s' % sorted(sets))
    return text


def _build(kernel, variants):
    """{variant: (library path, ptxas lines of the kernel)}."""
    from pyimsegm_tpu_torch import _build as build
    source, symbol, _ = KERNELS[kernel]
    with open(os.path.join(build.CSRC, source + '.cu')) as f:
        text = f.read()
    out_dir = os.path.join(build.BUILD_DIR, 'ab')
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for i, v in enumerate(variants):
        src = os.path.join(out_dir, '%s_ab_%d.cu' % (source, i))
        with open(src, 'w') as f:
            f.write(_variant_source(kernel, v, text))
        lib = os.path.join(out_dir, 'lib%s_ab_%d.so' % (source, i))
        procs[v] = (lib, subprocess.Popen(
            [build._nvcc()] + build.NVCC_FLAGS
            + ['-I', build.CSRC, '-Xptxas', '-v', '-o', lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for v, (lib, proc) in procs.items():
        log = proc.communicate()[0].splitlines()
        if proc.returncode != 0:
            raise RuntimeError('nvcc failed for %s:\n%s' % (v, '\n'.join(log)))
        info = []
        for i, line in enumerate(log):
            if symbol in line and 'Compiling' in line:
                info.append(' '.join(s.split('ptxas info    : ')[-1].strip()
                                     for s in log[i + 2:i + 4]))
        out[v] = (lib, info)
    return out


def _in_turns(torch, fns, check):
    """{variant: [ms, ms]}: each variant's ``fn`` checked once, then timed
    over REPS calls, variants in order and then reversed."""
    times = {v: [] for v in fns}
    for order in (list(fns), list(fns)[::-1]):
        for v in order:
            fns[v]()
            torch.cuda.synchronize()
            check(v)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(REPS):
                fns[v]()
            end.record()
            torch.cuda.synchronize()
            times[v].append(round(start.elapsed_time(end) / REPS, 4))
    return times


def _schedule(torch, libs, build):
    from pyimsegm_tpu_torch.ops import slic as slic_ops
    from pyimsegm_tpu_torch.ops import slic_cuda
    from pyimsegm_tpu_torch.utils.data_samples import \
        sample_color_image_rand_segment
    cfg = slic_ops.slic_config(CROP[0], CROP[1], SP_SIZE)
    m = slic_ops.compactness_from_regul(SP_SIZE, SP_REGUL)
    sw, m2 = slic_ops.slic_weights(m, cfg)
    n_upd = slic_ops.DEFAULT_SLIC_ITERS - 1
    k = cfg.n_segments
    images = {
        'image0': sample_color_image_rand_segment(CROP, 3, rand_seed=0)[0],
        'noise': np.random.default_rng(0).random(CROP + (3,),
                                                 dtype=np.float32)}
    dlls = {}
    for v, (lib, _) in libs.items():
        dll = ctypes.CDLL(lib)
        dll.slic_schedule.argtypes = ([build.VOIDP] * 4 + [build.FLOAT] * 3
                                      + [build.INT] * 7 + [build.VOIDP])
        dll.slic_schedule.restype = ctypes.c_int
        dlls[v] = dll

    for name, image in images.items():
        img = torch.as_tensor(image, device='cuda')
        lab, cen = slic_ops._prepare_chw(img, cfg)
        for slico in (False, True):
            nc, pch = (6, 7) if slico else (5, 6)
            want = slic_cuda._slic_multi_update_plain(lab, cen, m, cfg, n_upd,
                                                      slico)
            out = torch.empty((cfg.grid_h, cfg.grid_w, nc), device='cuda')
            scratch = torch.empty(2 * k * (nc + 9 * pch), device='cuda')

            def call(dll):
                return lambda: build.check(dll.slic_schedule(
                    lab.data_ptr(), cen.data_ptr(), out.data_ptr(),
                    scratch.data_ptr(), sw, m2, float(np.float32(m) ** 2),
                    cfg.height, cfg.width, cfg.grid_h, cfg.grid_w, cfg.step,
                    n_upd, int(slico), build.stream_ptr(lab)),
                    'slic_schedule')

            def check(v):
                err = float((out - want).abs().max())
                if not err <= 1e-3:
                    raise AssertionError('%s %s slico=%s: centres differ by '
                                         '%g' % (v, name, slico, err))

            key = '%s %s' % (name, 'slico' if slico else 'plain')
            times = _in_turns(torch, {v: call(d) for v, d in dlls.items()},
                              check)
            print('%s ms per schedule (in turns): %s'
                  % (key, json.dumps(times)), flush=True)


def _moments(torch, libs, build):
    from pyimsegm_tpu_torch.ops import grid as grid_ops
    from pyimsegm_tpu_torch.ops import grid_cuda
    from pyimsegm_tpu_torch.ops import slic as slic_ops
    from pyimsegm_tpu_torch.utils.data_samples import \
        sample_color_image_rand_segment
    cfg = slic_ops.slic_config(CROP[0], CROP[1], SP_SIZE)
    m = slic_ops.compactness_from_regul(SP_SIZE, SP_REGUL)
    img = torch.as_tensor(sample_color_image_rand_segment(
        CROP, 3, rand_seed=0)[0], device='cuda')
    labels, _, centers, _ = slic_ops.slic_segment_with_features(img, img,
                                                                cfg, m)
    enf = grid_ops.enforce_grid_connectivity(labels, cfg, centers=centers)
    counts, sym25, counts9 = grid_ops.counts_and_contacts(enf, cfg)
    chain = grid_ops.donor_chain_table(counts, sym25, cfg.grid_h, cfg.grid_w,
                                       int(0.5 * cfg.step ** 2),
                                       counts9=counts9)
    rng = np.random.default_rng(1)
    gy, gx = np.divmod(np.arange(cfg.n_segments), cfg.grid_w)
    ny = np.clip(gy + rng.integers(-1, 2, gy.size), 0, cfg.grid_h - 1)
    nx = np.clip(gx + rng.integers(-1, 2, gx.size), 0, cfg.grid_w - 1)
    window = torch.as_tensor(ny * cfg.grid_w + nx, device='cuda')
    k = cfg.n_segments
    dlls = {}
    for v, (lib, _) in libs.items():
        dll = ctypes.CDLL(lib)
        dll.grid_moments_apply.argtypes = ([build.VOIDP] * 6
                                           + [build.INT] * 6 + [build.VOIDP])
        dll.grid_moments_apply.restype = ctypes.c_int
        dlls[v] = dll
    merged = torch.empty_like(enf)
    partials = torch.empty((k * 81,), device='cuda')
    out = torch.empty((k, 9), device='cuda')
    for name, donor in (('chain donors', chain), ('window donors', window)):
        donor = donor.to(torch.int64).contiguous()
        want_l, want_s = grid_cuda._grid_moments_apply_plain(img, enf, donor,
                                                             cfg)

        def call(dll):
            return lambda: build.check(dll.grid_moments_apply(
                img.data_ptr(), enf.data_ptr(), donor.data_ptr(),
                merged.data_ptr(), partials.data_ptr(), out.data_ptr(),
                CROP[0], CROP[1], cfg.grid_h, cfg.grid_w, cfg.step, 1,
                build.stream_ptr(img)), 'grid_moments_apply')

        def check(v):
            diff = (out - want_s).abs()
            scale = want_s.abs().amax(dim=0, keepdim=True)
            if not (torch.equal(merged, want_l) and bool(
                    (diff <= 1e-5 * want_s.abs() + 1e-5 * scale).all())):
                raise AssertionError('%s %s: differs from the twin'
                                     % (v, name))

        times = _in_turns(torch, {v: call(d) for v, d in dlls.items()},
                          check)
        print('%s ms per call (in turns, %d px merged): %s'
              % (name, int((want_l != enf).sum()), json.dumps(times)),
              flush=True)
        for v, dll in dlls.items():
            print('%s %s device us per CUDA kernel (torch.profiler, 5 calls): '
                  '%s' % (name, v, json.dumps(_kernel_us(torch, call(dll)))),
                  flush=True)


def _reduce(torch, libs, build):
    from pyimsegm_tpu_torch.ops import grid_cuda
    from pyimsegm_tpu_torch.ops import slic as slic_ops
    from pyimsegm_tpu_torch.utils.data_samples import \
        sample_color_image_rand_segment
    cfg = slic_ops.slic_config(CROP[0], CROP[1], SP_SIZE)
    m = slic_ops.compactness_from_regul(SP_SIZE, SP_REGUL)
    img = torch.as_tensor(sample_color_image_rand_segment(
        CROP, 3, rand_seed=0)[0], device='cuda')
    labels = slic_ops.slic_segment_with_features(img, img, cfg, m)[0]
    labels = labels.contiguous()
    dlls = {}
    for v, (lib, _) in libs.items():
        dll = ctypes.CDLL(lib)
        dll.grid_reduce.argtypes = ([build.VOIDP] * 4 + [build.INT] * 7
                                    + [build.VOIDP])
        dll.grid_moments.argtypes = ([build.VOIDP] * 4 + [build.INT] * 6
                                     + [build.VOIDP])
        dll.grid_reduce.restype = dll.grid_moments.restype = ctypes.c_int
        dlls[v] = dll
    rng = np.random.default_rng(3)
    for row, f, dtype in ((6, 7, torch.float32), (6, 7, torch.bfloat16),
                          (6, 4, torch.float32), (6, 30, torch.bfloat16),
                          (7, 3, torch.float32), (7, 18, torch.float32),
                          (7, 60, torch.float32)):
        data = torch.as_tensor(rng.normal(size=CROP + (f,)).astype(
            np.float32), device='cuda').to(dtype)
        nch = f if row == 6 else 2 * f + 3
        partials = torch.empty((cfg.n_segments * 9 * nch,), device='cuda')
        out = torch.empty((cfg.n_segments, nch), device='cuda')
        if row == 6:
            want = grid_cuda._grid_reduce_plain(data, labels, cfg)
        else:
            want = grid_cuda._grid_moments_apply_plain(data, labels, None,
                                                       cfg)[1]

        def call(dll, row=row, data=data, f=f, partials=partials, out=out):
            args = (data.data_ptr(), labels.data_ptr(), partials.data_ptr(),
                    out.data_ptr(), CROP[0], CROP[1], f, cfg.grid_h,
                    cfg.grid_w, cfg.step)
            if row == 6:
                return lambda: build.check(dll.grid_reduce(
                    *args, int(data.dtype == torch.bfloat16),
                    build.stream_ptr(data)), 'grid_reduce')
            return lambda: build.check(dll.grid_moments(
                *args, build.stream_ptr(data)), 'grid_moments')

        def check(v, want=want, out=out, key=(row, f)):
            if not _sums_ok(out, want):
                raise AssertionError('%s row %d F=%d: differs from the twin'
                                     % ((v,) + key))

        key = 'row %d F=%d %s' % (row, f, str(dtype).split('.')[-1])
        times = _in_turns(torch, {v: call(d) for v, d in dlls.items()},
                          check)
        print('%s ms per call (in turns): %s' % (key, json.dumps(times)),
              flush=True)
        for v, dll in dlls.items():
            print('%s %s device us per CUDA kernel (torch.profiler, 5 '
                  'calls): %s' % (key, v, json.dumps(_kernel_us(
                      torch, call(dll)))), flush=True)


def _div_check(torch, build):
    """The exhaustive check of row 1's FMA division form: mismatches of
    each constant divisor over all 2^32 inputs, and the first input."""
    out_dir = os.path.join(build.BUILD_DIR, 'ab')
    src = os.path.join(out_dir, 'prep_div_check.cu')
    lib = os.path.join(out_dir, 'libprep_div_check.so')
    with open(src, 'w') as f:
        f.write(DIV_CHECK)
    subprocess.run([build._nvcc()] + build.NVCC_FLAGS + ['-o', lib, src],
                   check=True)
    dll = ctypes.CDLL(lib)
    dll.prep_div_check.argtypes = [build.VOIDP] * 3
    dll.prep_div_check.restype = ctypes.c_int
    bad = torch.zeros(len(DIVISORS), dtype=torch.int64, device='cuda')
    first = torch.full((len(DIVISORS),), -1, dtype=torch.int32,
                       device='cuda')
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    build.check(dll.prep_div_check(bad.data_ptr(), first.data_ptr(),
                                   build.stream_ptr(bad)), 'prep_div_check')
    end.record()
    torch.cuda.synchronize()
    for i, c in enumerate(DIVISORS):
        n = int(bad[i])
        print('division by %s: %d of 2^32 inputs differ from __fdiv_rn%s'
              % (c, n, ' (first 0x%08x)' % (int(first[i]) & 0xffffffff)
                 if n else ''), flush=True)
    print('division check: %.1f ms for %d launches'
          % (start.elapsed_time(end), len(DIVISORS)), flush=True)


def _prep(torch, libs, build):
    import chip_smoke
    from pyimsegm_tpu_torch.ops import prep_cuda
    from pyimsegm_tpu_torch.utils.data_samples import \
        sample_color_image_rand_segment
    _div_check(torch, build)
    dlls = {}
    for v, (lib, _) in libs.items():
        dll = ctypes.CDLL(lib)
        dll.blur_lab.argtypes = ([build.VOIDP] * 3 + [build.INT] * 3
                                 + [build.FLOAT] * 9 + [build.VOIDP])
        dll.blur_lab.restype = ctypes.c_int
        dlls[v] = dll
    images = {'884x1200': sample_color_image_rand_segment(
                  CROP, 3, rand_seed=0)[0],
              '883x1197': sample_color_image_rand_segment(
                  (883, 1197), 3, rand_seed=0)[0],
              '4096x4096': sample_color_image_rand_segment(
                  (4096, 4096), 3, rand_seed=0)[0]}
    parts = torch.empty((prep_cuda._PARTS, 2), device='cuda')
    for name, image in images.items():
        img = torch.as_tensor(image, device='cuda')
        h, w = img.shape[:2]
        want = prep_cuda._blur_lab_plain(img)
        out = torch.empty_like(want)

        def call(dll, img=img, out=out, h=h, w=w):
            return lambda: build.check(dll.blur_lab(
                img.data_ptr(), parts.data_ptr(), out.data_ptr(), h, w,
                prep_cuda._PARTS, *prep_cuda._taps(), build.stream_ptr(img)),
                'blur_lab')

        def check(v, out=out, want=want, name=name):
            equal, ulps = chip_smoke._bf16_agree(torch, out, want)
            if equal < 0.9999 or ulps > 1:
                raise AssertionError('%s %s: %.6f equal, max %d ulp'
                                     % (v, name, equal, ulps))
        times = _in_turns(torch, {v: call(d) for v, d in dlls.items()},
                          check)
        print('%s ms per call (in turns): %s' % (name, json.dumps(times)),
              flush=True)
        for v, dll in dlls.items():
            print('%s %s device us per CUDA kernel (torch.profiler, 5 calls): '
                  '%s' % (name, v, json.dumps(_kernel_us(torch, call(dll)))),
                  flush=True)


def _pair(torch, libs, build):
    from pyimsegm_tpu_torch.ops import grid as grid_ops
    from pyimsegm_tpu_torch.ops import grid_cuda
    from pyimsegm_tpu_torch.ops import slic as slic_ops
    from pyimsegm_tpu_torch.utils.data_samples import \
        sample_color_image_rand_segment
    cfg = slic_ops.slic_config(CROP[0], CROP[1], SP_SIZE)
    m = slic_ops.compactness_from_regul(SP_SIZE, SP_REGUL)
    gh, gw, k = cfg.grid_h, cfg.grid_w, cfg.n_segments
    dlls = {}
    for v, (lib, _) in libs.items():
        dll = ctypes.CDLL(lib)
        dll.grid_pair_count.argtypes = ([build.VOIDP] * 5 + [build.INT] * 5
                                        + [build.VOIDP])
        dll.grid_pair_count.restype = ctypes.c_int
        dlls[v] = dll
    images = {
        'image0': sample_color_image_rand_segment(CROP, 3, rand_seed=0)[0],
        'noise': np.random.default_rng(0).random(CROP + (3,),
                                                 dtype=np.float32)}
    cnt9 = torch.empty((gh, gw, 9, 25), device='cuda')
    counts9 = torch.empty((gh, gw, 9), device='cuda')
    counts = torch.empty((k,), device='cuda')
    sym25 = torch.empty((gh, gw, 25), device='cuda')
    for name, image in images.items():
        img = torch.as_tensor(image, device='cuda')
        labels, _, centers, _ = slic_ops.slic_segment_with_features(
            img, img, cfg, m)
        enf = grid_ops.enforce_grid_connectivity(labels, cfg,
                                                 centers=centers)
        want = (*grid_cuda._grid_pair_count_plain(enf, cfg),
                *grid_cuda._counts_and_contacts_plain(enf, cfg)[:2])

        def call(dll, enf=enf):
            return lambda: build.check(dll.grid_pair_count(
                enf.data_ptr(), cnt9.data_ptr(), counts9.data_ptr(),
                counts.data_ptr(), sym25.data_ptr(), CROP[0], CROP[1], gh, gw,
                cfg.step, build.stream_ptr(enf)), 'grid_pair_count')

        def check(v, want=want, name=name):
            if 'probe' in v:                  # timing-only copies
                return
            if not all(torch.equal(a, b) for a, b in
                       zip((cnt9, counts9, counts, sym25), want)):
                raise AssertionError('%s %s: differs from the twin'
                                     % (v, name))
        times = _in_turns(torch, {v: call(d) for v, d in dlls.items()},
                          check)
        print('%s routed ms per call (in turns): %s'
              % (name, json.dumps(times)), flush=True)
        for v, dll in dlls.items():
            print('%s %s device us per CUDA kernel (torch.profiler, 5 calls): '
                  '%s' % (name, v, json.dumps(_kernel_us(torch, call(dll)))),
                  flush=True)


def _adj(torch, libs, build):
    from pyimsegm_tpu_torch.ops import grid as grid_ops
    from pyimsegm_tpu_torch.ops import grid_cuda
    from pyimsegm_tpu_torch.ops import slic as slic_ops
    from pyimsegm_tpu_torch.utils.data_samples import \
        sample_color_image_rand_segment
    cfg = slic_ops.slic_config(CROP[0], CROP[1], SP_SIZE)
    m = slic_ops.compactness_from_regul(SP_SIZE, SP_REGUL)
    gh, gw = cfg.grid_h, cfg.grid_w
    dlls = {}
    for v, (lib, _) in libs.items():
        dll = ctypes.CDLL(lib)
        dll.grid_adjacency.argtypes = ([build.VOIDP] * 3 + [build.INT] * 5
                                       + [build.VOIDP])
        dll.grid_adjacency.restype = ctypes.c_int
        dlls[v] = dll
    images = {
        'image0': sample_color_image_rand_segment(CROP, 3, rand_seed=0)[0],
        'noise': np.random.default_rng(0).random(CROP + (3,),
                                                 dtype=np.float32)}
    words = torch.empty((gh, gw, 9), dtype=torch.int32, device='cuda')
    adj = torch.empty((gh, gw, 25), device='cuda')
    for name, image in images.items():
        img = torch.as_tensor(image, device='cuda')
        labels, _, centers, _ = slic_ops.slic_segment_with_features(
            img, img, cfg, m)
        enf = grid_ops.enforce_grid_connectivity(labels, cfg,
                                                 centers=centers)
        for kind, lab in (('SLIC', labels), ('enforced', enf)):
            want = (grid_cuda._grid_adjacency_presence_plain(lab, cfg),
                    grid_cuda._grid_adjacency_plain(lab, cfg))

            def call(dll, lab=lab):
                return lambda: build.check(dll.grid_adjacency(
                    lab.data_ptr(), words.data_ptr(), adj.data_ptr(),
                    CROP[0], CROP[1], gh, gw, cfg.step,
                    build.stream_ptr(lab)), 'grid_adjacency')

            def check(v, want=want, what='%s %s' % (name, kind)):
                if not (torch.equal(words, want[0])
                        and torch.equal(adj, want[1])):
                    raise AssertionError('%s %s: differs from the twin'
                                         % (v, what))
            times = _in_turns(torch, {v: call(d) for v, d in dlls.items()},
                              check)
            print('%s %s labels: routed ms per call (in turns): %s'
                  % (name, kind, json.dumps(times)), flush=True)
            for v, dll in dlls.items():
                print('%s %s %s device us per CUDA kernel (torch.profiler, '
                      '5 calls): %s' % (name, kind, v, json.dumps(
                          _kernel_us(torch, call(dll)))), flush=True)


def _sass(libs, build):
    """Print each variant's SASS instruction count per kernel, whole and
    between block barriers."""
    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), 'cuobjdump')
    for v, (lib, _) in libs.items():
        text = subprocess.run([cuobjdump, '--dump-sass', lib],
                              capture_output=True, text=True,
                              check=True).stdout
        for block in text.split('Function : ')[1:]:
            name = block.split('\n', 1)[0].strip()
            ops = [line.split('*/', 1)[1].strip()
                   for line in block.splitlines()
                   if re.match(r'\s*/\*[0-9a-f]{4,}\*/', line)]
            ops = [op for op in ops if op and not op.startswith('NOP')]
            phases, n = [], 0
            for op in ops:
                n += 1
                if 'BAR.SYNC' in op:
                    phases.append(n)
                    n = 0
            phases.append(n)
            print('sass %s %s: %d instructions, by barrier %s'
                  % (v, name[:60], len(ops), phases), flush=True)


def _sums_ok(got, want):
    """rtol 1e-5 plus 1e-5 of the channel's largest value."""
    diff = (got - want).abs()
    scale = want.abs().reshape(-1, want.shape[-1]).amax(dim=0)
    return bool((diff <= 1e-5 * want.abs() + 1e-5 * scale).all())


def _assign(torch, libs, build):
    from pyimsegm_tpu_torch.ops import slic as slic_ops
    from pyimsegm_tpu_torch.ops import slic_cuda
    from pyimsegm_tpu_torch.utils.data_samples import \
        sample_color_image_rand_segment
    cfg = slic_ops.slic_config(CROP[0], CROP[1], SP_SIZE)
    m = slic_ops.compactness_from_regul(SP_SIZE, SP_REGUL)
    sw, m2 = slic_ops.slic_weights(m, cfg)
    n_upd = slic_ops.DEFAULT_SLIC_ITERS - 1
    gh, gw = cfg.grid_h, cfg.grid_w
    images = {
        'image0': sample_color_image_rand_segment(CROP, 3, rand_seed=0)[0],
        'noise': np.random.default_rng(0).random(CROP + (3,),
                                                 dtype=np.float32)}
    dlls = {}
    for v, (lib, _) in libs.items():
        dll = ctypes.CDLL(lib)
        dll.slic_assign_pool.argtypes = ([build.VOIDP] * 6 + [build.FLOAT] * 2
                                         + [build.INT] * 6 + [build.VOIDP])
        dll.slic_assign_pool.restype = ctypes.c_int
        dlls[v] = dll
    for name, image in images.items():
        img = torch.as_tensor(image, device='cuda')
        lab, cen0 = slic_ops._prepare_chw(img, cfg)
        cen = slic_cuda.slic_multi_update(lab, cen0, m, cfg, n_upd)
        lb_w, part_w, sums_w = slic_cuda._slic_update_labels_plain(
            lab, cen, m, cfg, feat=img)
        part6_w = slic_cuda._slic_update_plain(lab, cen, m, cfg)
        labels = torch.empty((cfg.pad_h, cfg.pad_w), dtype=torch.int32,
                             device='cuda')
        part = torch.empty((gh, gw, 9, 12), device='cuda')
        part6 = torch.empty((gh, gw, 9, 6), device='cuda')
        sums = torch.empty((gh, gw, 12), device='cuda')
        modes = {
            'row3': (img, labels, part, sums, lambda: (
                torch.equal(labels, lb_w) and _sums_ok(part, part_w)
                and _sums_ok(sums, sums_w))),
            'row4': (None, labels, None, None,
                     lambda: torch.equal(labels, lb_w)),
            'row5': (None, None, part6, None,
                     lambda: _sums_ok(part6, part6_w))}
        for mode, (feat, lbl, prt, sms, ok) in modes.items():
            def call(dll, feat=feat, lbl=lbl, prt=prt, sms=sms):
                ptr = (lambda t: None if t is None else t.data_ptr())
                return lambda: build.check(dll.slic_assign_pool(
                    lab.data_ptr(), cen.data_ptr(), ptr(feat), ptr(lbl),
                    ptr(prt), ptr(sms), sw, m2, cfg.height, cfg.width, gh, gw,
                    cfg.step, 0, build.stream_ptr(lab)), 'slic_assign_pool')

            def check(v, ok=ok, mode=mode):
                if not ok():
                    raise AssertionError('%s %s %s: differs from the twin'
                                         % (v, name, mode))
            times = _in_turns(torch, {v: call(d) for v, d in dlls.items()},
                              check)
            print('%s %s ms per call (in turns): %s'
                  % (name, mode, json.dumps(times)), flush=True)
            for v, dll in dlls.items():
                print('%s %s %s device us per CUDA kernel (torch.profiler, 5 '
                      'calls): %s' % (name, mode, v, json.dumps(_kernel_us(
                          torch, call(dll)))), flush=True)


def _slic3d(torch, libs, build):
    from pyimsegm_tpu_torch.ops import slic3d, slic3d_cuda
    from pyimsegm_tpu_torch.ops.slic import compactness_from_regul
    from pyimsegm_tpu_torch.utils.data_samples import sample_gray_volume_3d
    shape, spacing, sp = (48, 640, 768), (4, 1, 1), 15
    cfg = slic3d.slic3d_config(shape, sp, spacing)
    m = compactness_from_regul(sp, 0.2)
    (sp_z, sp_y, sp_x), sw, m2 = slic3d.slic3d_weights(m, cfg)
    vol_p, c0 = slic3d._prep3d(torch.as_tensor(
        sample_gray_volume_3d(shape)[0], device='cuda'), cfg)
    dlls = {}
    for v, (lib, _) in libs.items():
        dll = ctypes.CDLL(lib)
        dll.slic3d_run.argtypes = ([build.VOIDP] * 5 + [build.FLOAT] * 5
                                   + [build.INT] * 10 + [build.VOIDP])
        dll.slic3d_run.restype = ctypes.c_int
        dlls[v] = dll
    lb_w = slic3d_cuda._slic3d_labels_plain(vol_p, c0, m, cfg)
    part_w = slic3d_cuda._slic3d_partials_plain(vol_p, c0, m, cfg)
    it_w = slic3d_cuda._slic3d_iterate_plain(vol_p, c0, m, cfg, 10)
    labels = torch.empty(cfg.pad, dtype=torch.int32, device='cuda')
    part = torch.empty(cfg.grid + (27, 5), device='cuda')
    work = torch.empty_like(c0)
    modes = {'schedule': (work, labels, part, 9, lambda: float(
                 (labels == it_w).float().mean()) >= 0.999),
             'labels': (None, labels, None, 0,
                        lambda: torch.equal(labels, lb_w)),
             'partials': (None, None, part, 0,
                          lambda: _sums_ok(part, part_w))}
    for mode, (wk, lbl, prt, n_upd, ok) in modes.items():
        def call(dll, wk=wk, lbl=lbl, prt=prt, n_upd=n_upd):
            ptr = (lambda t: None if t is None else t.data_ptr())
            return lambda: build.check(dll.slic3d_run(
                vol_p.data_ptr(), c0.data_ptr(), ptr(wk), ptr(lbl), ptr(prt),
                sp_z, sp_y, sp_x, sw, m2, *cfg.shape, *cfg.grid, *cfg.steps,
                n_upd, build.stream_ptr(vol_p)), 'slic3d_run')

        def check(v, ok=ok, mode=mode):
            if v not in PROBES and not ok():
                raise AssertionError('%s %s: differs from the twin'
                                     % (v, mode))
        times = _in_turns(torch, {v: call(d) for v, d in dlls.items()
                                  if v != 'phases'}, check)
        print('3D %s ms per call (in turns): %s' % (mode, json.dumps(times)),
              flush=True)
        if 'phases' in dlls and n_upd == 0:
            dll = dlls['phases']
            dll.slic3d_probe.argtypes = [build.VOIDP, build.INT]
            dll.slic3d_probe.restype = ctypes.c_int
            counts = np.zeros(5, np.uint64)
            call(dll)()
            torch.cuda.synchronize()
            build.check(dll.slic3d_probe(None, 1), 'slic3d_probe')
            call(dll)()
            torch.cuda.synchronize()
            build.check(dll.slic3d_probe(counts.ctypes.data, 0),
                        'slic3d_probe')
            cycles = counts[:4].astype(np.float64)
            print('3D %s pass: clock64 cycles per work item (wait for the '
                  'copies, tables, evaluate, store or reduce) %s, shares %s, '
                  'over %d '
                  'items' % (mode, [round(c / counts[4], 1) for c in cycles],
                             [round(c / cycles.sum(), 3) for c in cycles],
                             int(counts[4])), flush=True)


def _kernel_us(torch, fn, reps=5):
    """{CUDA kernel name: mean device us per call} over ``reps`` calls."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if str(e.device_type).endswith('CUDA'):
            key = e.name.split('(')[0][:40]
            out[key] = out.get(key, 0.0) + e.time_range.elapsed_us() / reps
    return {k: round(v, 3) for k, v in out.items()}


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--kernel', choices=sorted(KERNELS),
                        default='schedule')
    parser.add_argument('--variants', default=None,
                        help='comma-separated variants')
    parser.add_argument('--probe', action='store_true',
                        help='slic3d only: the phase and one-candidate '
                             'probes')
    parser.add_argument('--sass', action='store_true',
                        help='print the SASS instruction counts and stop')
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('ab_kernels: no CUDA device')
    sys.path.insert(0, ROOT)
    from pyimsegm_tpu_torch import _build as build
    print(subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    variants = (args.variants or KERNELS[args.kernel][2]).split(',')
    if args.probe:
        if args.kernel != 'slic3d':
            raise SystemExit('ab_kernels: --probe is for --kernel slic3d')
        variants = ['base'] + list(PROBES)
    libs = _build(args.kernel, variants)
    for v, (_, info) in libs.items():
        print('variant %s: %s' % (v, ' | '.join(info)), flush=True)
    if args.sass:
        _sass(libs, build)
        return
    {'schedule': _schedule, 'moments': _moments, 'assign': _assign,
     'slic3d': _slic3d, 'reduce': _reduce, 'prep': _prep,
     'pair': _pair, 'adj': _adj}[args.kernel](torch, libs, build)


if __name__ == '__main__':
    main()
