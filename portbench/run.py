"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks for.
Set-up makes the cell's pool of inputs from the seed, the model, and warm
calls; an untraced run (``--trace 0``) then calls the entry in a closed loop
for ``--seconds`` and reports the cell's end-to-end metrics; a traced run
(``--trace 1``) calls it once on each pool item under ``torch.profiler``
and reports the per-layer metrics.  Either way, once the window has
closed, a sample of the pool drawn from the seed goes through the entry
once more, handing back its intermediate results, and is held against the
plain reference on the same inputs (``correct``).  The last line of standard output is one JSON object;
the numbers compared, each beside its limit, are the last lines of
standard error and the last key of that object.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time
import traceback

def _process_start():
    """Wall-clock time at which this process started."""
    try:
        with open('/proc/self/stat') as fh:
            start_ticks = int(fh.read().rsplit(')', 1)[1].split()[19])
        with open('/proc/uptime') as fh:
            uptime = float(fh.read().split()[0])
        return time.time() - (uptime - start_ticks / os.sysconf('SC_CLK_TCK'))
    except (OSError, ValueError, IndexError):
        return time.time()


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the program's kernel caches, at fixed paths inside the checkout
CACHE_DIRS = {'TORCH_EXTENSIONS_DIR': os.path.join(ROOT, 'build',
                                                   'torch_extensions'),
              'TRITON_CACHE_DIR': os.path.join(ROOT, 'build', 'triton_cache')}

#: the system under test
PROGRAM = 'pyimsegm_tpu_torch'
#: top-level modules that no run may hold once its window has closed
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'pyimsegm_tpu')


def forbidden_modules(modules=None):
    """Forbidden top-level names among the loaded modules, compared whole."""
    names = {m.split('.')[0] for m in (sys.modules if modules is None
                                       else modules)}
    return sorted(names & set(FORBIDDEN))


def check_positions(mix, seed):
    """The pool positions checked against the reference once the window
    has closed, drawn from the seed."""
    import numpy as np
    rng = np.random.default_rng(np.random.SeedSequence(
        [int(seed) & (2 ** 64 - 1), 0x636865636b]))
    return set(int(i) for i in rng.choice(int(mix['pool']),
                                          int(mix['check_items']),
                                          replace=False))


class Window:
    """The closed loop of one client over the pool: call after call until
    the window's time is up; every call that starts is finished and
    counted."""

    def __init__(self, driver, pool):
        self.driver, self.pool = driver, pool
        self.latencies, self.failed = [], 0

    def _one(self, i):
        t0 = time.perf_counter()
        try:
            self.driver.call(self.pool[i % len(self.pool)])
        except Exception:                       # noqa: BLE001
            self.failed += 1
            if self.failed == 1:
                traceback.print_exc()
        t1 = time.perf_counter()
        self.latencies.append(t1 - t0)
        return t0, t1

    def run_for(self, seconds):
        start, i = None, 0
        while True:
            t0, t1 = self._one(i)
            start = t0 if start is None else start
            i += 1
            if t1 - start >= seconds:
                return t1 - start


def judge_items(driver, config, items, control=False):
    """(numbers of each item, check rows, whether all are within their
    limits) of the check items ``items``: the program's capture of each
    (the timed call that also hands back its intermediate results) or,
    with ``control``, the reference in the configuration's control
    precision (a precision's name: in that one) in the program's place,
    judged by the float32 reference against ``config['checks']``.  A call
    that raises judges as missing numbers, which fail."""
    from portbench import compare
    outputs = []
    for item in items:
        try:
            if control:
                mode = control if isinstance(control, str) else None
                outputs.append(driver.control(item, mode))
            else:
                outputs.append(driver.capture(item))
        except Exception:                       # noqa: BLE001
            traceback.print_exc()
            outputs.append(None)
    import torch
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    per_item = [{} if out is None else driver.judge(item, out)
                for item, out in zip(items, outputs)]
    rows = compare.judge(compare.worst(per_item), config['checks'])
    return per_item, rows, bool(rows) and all(ok for *_, ok in rows)


def _power_limit():
    try:
        return subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return 'not read'


def run_cell(cell, seed, seconds, trace, device='cuda',
             process_start=None, control=False):
    """One run of a resolved cell; returns (result dict, check rows).
    ``setup_s`` counts from ``process_start`` (this process's start by
    default).  Once the window has closed, the check items drawn from the
    seed go through the same driver once more, handing back their
    intermediate results, and are judged by the reference; with
    ``control`` the reference in the control precision takes the
    program's place there (the harness's own check that the limits catch
    it)."""
    import torch

    from portbench import trace as tr
    from portbench.traffic import generate

    config, mix = cell['config'], cell['mix']
    cuda = torch.device(device).type == 'cuda'
    process_start = process_start or _process_start()
    marks = [('start', time.time())]
    pool = generate.make_pool(mix, seed, device)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    marks.append(('pool', time.time()))
    driver = cell['driver'].Driver(config, device)
    driver.setup()
    marks.append(('model', time.time()))
    for i in range(int(mix['warm_calls'])):
        driver.call(pool[i % len(pool)])
        if cuda:
            torch.cuda.synchronize()
        marks.append(('warm call %d' % (i + 1), time.time()))
    setup_s = time.time() - process_start
    steps = ', '.join('%s %.3f s' % (name, t - marks[k][1])
                      for k, (name, t) in enumerate(marks[1:]))
    print('set-up: imports %.3f s, %s' % (marks[0][1] - process_start, steps),
          file=sys.stderr)

    window = Window(driver, pool)
    metrics, extra = {}, {}
    if not trace:
        window_s = window.run_for(seconds)
        data = {'latencies_s': window.latencies, 'window_s': window_s,
                'elements': generate.picture_elements(mix),
                'setup_s': setup_s}
        metrics = {n: mod.read(data) for n, mod in cell['end_to_end'].items()}
    else:
        summary = None
        for attempt in range(3):
            events = tr.profile_items(
                lambda _: window._one(len(window.latencies)),
                range(int(mix['trace_items'])))
            try:
                summary = tr.summarise(events)
                ctx = {'summary': summary, 'config': config, 'mix': mix}
                metrics = {n: mod.read(ctx)
                           for n, mod in cell['per_layer'].items()}
                break
            except tr.TraceError as err:
                print('trace attempt %d: %s' % (attempt + 1, err),
                      file=sys.stderr)
                summary = None
        if summary is None:
            raise tr.TraceError('the profiler dropped events in 3 traces')
        extra = {'busy_s': summary['busy_us'] / 1e6,
                 'window_s': summary['window_us'] / 1e6}
        breakdown = {'device_ops': tr.top(summary['device_ops']),
                     'idle_gaps': tr.top(summary['idle_by_range'])}
    missing = [n for n, v in metrics.items() if v is None]
    if missing:
        raise RuntimeError('no reading for %s in %s' % (
            ', '.join(missing), cell['workload']['name']))
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    attempted, failed = len(window.latencies), window.failed
    _, rows, within = judge_items(
        driver, config, [pool[j] for j in sorted(check_positions(mix, seed))],
        control)
    correct = within and failed == 0
    result = {
        'correct': correct, 'attempted': attempted, 'failed': failed,
        'metrics': {n: {'value': v, 'unit': cell['units'][n]}
                    for n, v in metrics.items()},
        'device': dict({'platform': 'gpu' if cuda else 'cpu',
                        'kind': (torch.cuda.get_device_name(0) if cuda
                                 else 'cpu'),
                        'count': int(cell['workload']['chips']),
                        'memory_peak_bytes': int(peak)}, **extra),
    }
    if trace:
        result['breakdown'] = breakdown
    result['checks'] = {n: {'value': v, 'limit': lim}
                        for n, v, lim, _ in rows}
    return result, rows


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seed', type=int, required=True)
    parser.add_argument('--seconds', type=float, required=True)
    parser.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    os.environ.update(CACHE_DIRS)
    os.environ.setdefault('USE_FLAX', '0')

    from portbench import manifest
    cell = manifest.cell(args.workload)
    import torch
    chips = int(cell['workload']['chips'])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print('portbench: %s needs %d CUDA device(s), found %d'
              % (args.workload, chips, torch.cuda.device_count()
                 if torch.cuda.is_available() else 0), file=sys.stderr)
        return 2
    if importlib.util.find_spec(PROGRAM) is None:
        print('portbench: the program %s is not in this checkout' % PROGRAM,
              file=sys.stderr)
        return 2
    result, rows = run_cell(cell, args.seed, args.seconds, args.trace)
    bad = forbidden_modules()
    if bad:
        print('portbench: loaded %s once the window had closed'
              % ', '.join(bad), file=sys.stderr)
        return 3
    print('card: %s' % _power_limit(), file=sys.stderr)
    for name, v, lim, ok in rows:
        print('check %s %r <= %r %s' % (name, v, lim, 'ok' if ok else 'FAIL'),
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == '__main__':
    sys.path.insert(0, ROOT)
    sys.exit(main())
