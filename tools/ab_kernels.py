"""Same-call A/B of build variants of kernel rows 2 and 8.

A variant is ``base`` (the source as it is) or ``KEY=V+KEY=V``: each KEY
names a constant of the kernel's source, and the variant is built from a
copy of the source with that constant set to V (the tool fails if the
constant's definition is not found once).

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

``--kernel moments`` (row 8, the donor apply + moments of
``csrc/grid.cu``): ``MOM_THREADS`` (block size).  It times
``grid_moments_apply`` on the enforced SLIC kernels' labels of image 0 with
the min-size donor table of the bench path, and with a donor table of
random seeds within one grid cell (most pixels merge), holding merged
labels exact and sums within rtol 1e-5 against the plain twin.

Each variant is built with ``nvcc -Xptxas -v``, all started together, and
its registers and spills are printed.  Times: CUDA events around 20 calls,
variants in turns (in order, then reversed).

Run from the root of a checkout on a machine with a CUDA card::

    python3 tools/ab_kernels.py --kernel schedule|moments \\
        [--variants base,PRUNE=1,...]
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
}
#: the schedule's keys: member of Sched<SLICO>, by key without _SLICO
SCHED_MEMBERS = {'THREADS': 'T', 'MIN_BLOCKS': 'MIN_BLOCKS',
                 'PRUNE': 'PRUNE'}


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
    sets = dict(kv.split('=') for kv in variant.split('+'))
    if kernel == 'moments':
        for key, v in sets.items():
            text = _sub_once(r'#define %s \S+' % re.escape(key),
                             '#define %s %s' % (key, v), text, key)
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
    libs = _build(args.kernel, variants)
    for v, (_, info) in libs.items():
        print('variant %s: %s' % (v, ' | '.join(info)), flush=True)
    (_schedule if args.kernel == 'schedule' else _moments)(torch, libs, build)


if __name__ == '__main__':
    main()
