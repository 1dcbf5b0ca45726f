"""Experiment harness: configs, folders, logging, a sequential / thread
map, stage timing (port of ``pyimsegm_tpu.utils.experiments``).

The heavy work of an app runs on the card inside one process, so
:class:`WrapExecuteSequence` is a thin sequential or thread mapper kept for
the reference's API (batch device work through
``pyimsegm_tpu_torch.parallel`` instead).  :class:`StageTimer` times stages
on the host clock; on a CUDA device each stage synchronises the device as
it ends, so that it counts the device work it queued.
"""

import contextlib
import logging
import multiprocessing
import os
import time
from concurrent.futures import ThreadPoolExecutor

import torch
import yaml

CONFIG_YAML = 'config.yml'
FILE_LOGS = 'logging.txt'
RESULTS_TXT = 'resultStat.txt'


def get_nb_workers(ratio=0.9):
    """Fraction of available CPUs."""
    return max(1, int(multiprocessing.cpu_count() * ratio))


class Experiment:
    """Base experiment: load data -> perform -> evaluate -> summarise."""

    def __init__(self, params, time_stamp=True):
        self.params = dict(params)
        self.params.setdefault('path_out', '.')
        if not os.path.isdir(self.params['path_out']):
            raise FileNotFoundError('no output path: %r'
                                    % self.params['path_out'])
        name = self.params.get('name', self.__class__.__name__)
        self.params['path_exp'] = create_experiment_folder(
            self.params['path_out'], name, stamp_unique=time_stamp)
        set_experiment_logger(self.params['path_exp'])
        save_config_yaml(os.path.join(self.params['path_exp'], CONFIG_YAML),
                         self.params)
        self._main_thread = True
        self.t_start = time.time()

    def run(self, gt=True):
        self._load_data(gt)
        self._perform()
        self._evaluate()
        self._summarise()

    def _load_data(self, gt=True):
        pass

    def _perform(self):
        pass

    def _evaluate(self):
        pass

    def _summarise(self):
        append_final_stat(self.params['path_exp'], self.params,
                          {}, self.t_start)


def create_experiment_folder(path_out, dir_name, stamp_unique=True):
    """Timestamped experiment folder + config dump."""
    if not os.path.isdir(path_out):
        raise FileNotFoundError('missing base folder: %r' % path_out)
    name = dir_name
    if stamp_unique:
        name += '_' + time.strftime('%Y%m%d-%H%M%S')
    path_exp = os.path.join(path_out, name)
    counter = 0
    while stamp_unique and os.path.exists(path_exp):
        counter += 1
        path_exp = os.path.join(path_out, '%s-%i' % (name, counter))
    os.makedirs(path_exp, exist_ok=True)
    return path_exp


def set_experiment_logger(path_out, file_name=FILE_LOGS, reset=True):
    """Attach a FileHandler writing into the experiment folder."""
    logger = logging.getLogger()
    if reset:
        for handler in list(logger.handlers):
            if isinstance(handler, logging.FileHandler):
                logger.removeHandler(handler)
    handler = logging.FileHandler(os.path.join(path_out, file_name))
    handler.setLevel(logging.DEBUG)
    handler.setFormatter(logging.Formatter(
        '%(asctime)s:%(levelname)s@%(filename)s:%(processName)s - '
        '%(message)s'))
    logger.addHandler(handler)
    return logger


def string_dict(d, headline='DICTIONARY:', offset=25):
    """Pretty one-per-line dict dump."""
    template = '{:%is} {}' % offset
    rows = [template.format('"{}":'.format(n), d[n]) for n in sorted(d)]
    return headline + '\n' + '\n'.join(rows)


def append_final_stat(path_exp, params, stats, time_start,
                      file_name=RESULTS_TXT):
    """Write final stats incl. total elapsed minutes."""
    t_total = time.time() - time_start
    lines = [string_dict(params, 'PARAMETERS:'), '',
             string_dict(stats, 'STATISTICS:'), '',
             'total time (min): %.2f' % (t_total / 60.0)]
    path = os.path.join(path_exp, file_name)
    with open(path, 'a') as fp:
        fp.write('\n'.join(lines) + '\n')
    return path


def extend_list_params(list_params, name_param, list_options):
    """Grid-expand parameter dicts."""
    if not isinstance(list_options, (list, tuple)):
        list_options = [list_options]
    out = []
    for params in list_params:
        if name_param not in params:
            out.append(params)
            continue
        for option in list_options:
            p = dict(params)
            p[name_param] = option
            p['name'] = p.get('name', '') + '_%s-%s' % (name_param, option)
            out.append(p)
    return out if out else list(list_params)


def try_decorator(func):
    """Swallow-and-log wrapper."""
    import functools

    @functools.wraps(func)
    def wrap(*args, **kwargs):
        try:
            return func(*args, **kwargs)
        except Exception:
            logging.exception('failed: %s', func.__name__)
            return None
    return wrap


def create_subfolders(path_out, folders):
    """Create the sub-folders of ``path_out``; returns how many exist."""
    count = 0
    for folder in folders:
        path = os.path.join(path_out, folder)
        try:
            os.makedirs(path, exist_ok=True)
            count += 1
        except Exception:
            logging.exception('cannot create %r', path)
    return count


class WrapExecuteSequence:
    """Map a function over an iterable with optional thread workers.

    API-compatible with the reference's pool wrapper; the default is
    sequential because the heavy work already runs on the device — prefer
    ``pyimsegm_tpu_torch.parallel.segment_images_batch`` for batching.
    """

    def __init__(self, wrap_func, iterate_vals, nb_workers=1, desc='',
                 ordered=True):
        self.wrap_func = wrap_func
        self.iterate_vals = list(iterate_vals)
        self.nb_workers = max(1, int(nb_workers or 1))
        self.desc = desc
        self.ordered = ordered

    def __iter__(self):
        if self.nb_workers == 1:
            for val in self.iterate_vals:
                yield self.wrap_func(val)
        else:
            with ThreadPoolExecutor(max_workers=self.nb_workers) as ex:
                if self.ordered:
                    yield from ex.map(self.wrap_func, self.iterate_vals)
                else:
                    from concurrent.futures import as_completed
                    futures = [ex.submit(self.wrap_func, v)
                               for v in self.iterate_vals]
                    for fut in as_completed(futures):
                        yield fut.result()

    def __len__(self):
        return len(self.iterate_vals)


def load_config_yaml(path_config):
    """The YAML config at ``path_config`` as a dict."""
    with open(path_config) as fp:
        return yaml.safe_load(fp)


def save_config_yaml(path_config, config):
    """Dump ``config`` as YAML; arrays and tensors become lists."""
    clean = {k: (v.tolist() if hasattr(v, 'tolist') else v)
             for k, v in config.items()}
    with open(path_config, 'w') as fp:
        yaml.safe_dump(clean, fp, default_flow_style=False)


class StageTimer:
    """Per-stage wall-clock accounting on the host clock.

    :param device: where the timed work runs; on a CUDA device a stage
        synchronises it before it reads the clock at its end, so that the
        kernels launched inside the stage count in it
    """

    def __init__(self, device=None):
        self.stages = {}
        self.device = None if device is None else torch.device(device)

    def _sync(self):
        if self.device is not None and self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def stage(self, name):
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            self.stages[name] = self.stages.get(name, 0.0) + (
                time.perf_counter() - t0)

    def report(self):
        total = sum(self.stages.values())
        lines = ['%-20s %8.1f ms (%4.1f%%)' % (k, v * 1e3, 100 * v / total)
                 for k, v in sorted(self.stages.items(),
                                    key=lambda kv: -kv[1])]
        return '\n'.join(lines + ['%-20s %8.1f ms' % ('TOTAL', total * 1e3)])


def is_iterable(var):
    """True for list/tuple/ndarray-like (not strings).

    >>> is_iterable('abc')
    False
    >>> is_iterable([0])
    True
    >>> is_iterable((1, ))
    True
    """
    return hasattr(var, '__iter__') and not isinstance(var, (str, bytes))
