"""Every public top-level name of every module of the JAX package, and of
its experiment apps (``apps/``), exists in its counterpart in the port,
apart from an explicit pending list, and every public function and class
takes the JAX parameters first, under their names.

A module's public names are those it defines (functions, classes,
assignments) and those it re-exports from the package itself; imported
modules and outside packages do not count.  The Pallas kernel modules are
ported as the CUDA kernels of their rows (``PERF.md``): each maps to the
wrapper module of its kernels.  The signature check reads JAX's ``key`` as
the port's ``generator`` and lets the port add trailing parameters that
have defaults (``device``, ``cfg``, ...)."""

import ast
import importlib
import inspect
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(ROOT, 'pyimsegm_tpu')
JAX_APPS = os.path.join(ROOT, 'apps')

#: the Pallas modules and the port's wrappers of the same kernels
KERNEL_MODULES = {
    'ops/prep_pallas.py': 'ops/prep_cuda.py',
    'ops/slic_pallas.py': 'ops/slic_cuda.py',
    'ops/grid_pallas.py': 'ops/grid_cuda.py',
    'ops/enforce_pallas.py': 'ops/enforce_cuda.py',
    'ops/connectivity_pallas.py': 'ops/connectivity_cuda.py',
    'ops/slic3d_pallas.py': 'ops/slic3d_cuda.py',
}
#: still to port: whole modules ('*') or names (none: the port is
#: complete)
PENDING = {}
#: apps still to port, as PENDING
PENDING_APPS = {}


def _jax_modules(root=JAX_PKG):
    out = []
    for dirpath, _, files in os.walk(root):
        for name in files:
            if name.endswith('.py'):
                out.append(os.path.relpath(os.path.join(dirpath, name),
                                           root).replace(os.sep, '/'))
    return sorted(out)


def _is_module(dotted):
    path = os.path.join(ROOT, *dotted.split('.'))
    return os.path.isfile(path + '.py') or os.path.isdir(path)


def _tree(rel, root=JAX_PKG):
    with open(os.path.join(root, rel)) as fp:
        return ast.parse(fp.read())


def _public_names(rel, root=JAX_PKG):
    tree = _tree(rel, root)
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            for target in node.targets:
                elts = target.elts if isinstance(target, ast.Tuple) \
                    else [target]
                names.update(e.id for e in elts if isinstance(e, ast.Name))
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.module.startswith('pyimsegm_tpu'):
            names.update(a.asname or a.name for a in node.names
                         if not _is_module(node.module + '.' + a.name))
    return {n for n in names if not n.startswith('_')}


def _port_module(rel, prefix='pyimsegm_tpu_torch'):
    parts = [prefix] + KERNEL_MODULES.get(rel, rel)[:-3].split('/')
    return '.'.join(parts[:-1] if parts[-1] == '__init__' else parts)


def _app_module(rel):
    return _port_module(rel, 'pyimsegm_tpu_torch.apps')


@pytest.mark.parametrize('rel', _jax_modules())
def test_port_has_every_public_name(rel):
    pending = PENDING.get(rel, set())
    if pending == '*':
        with pytest.raises(ImportError):
            importlib.import_module(_port_module(rel))
        return
    mod = importlib.import_module(_port_module(rel))
    if rel in KERNEL_MODULES:
        assert mod.LAUNCHES is not None
        return
    missing = sorted(n for n in _public_names(rel) - pending
                     if not hasattr(mod, n))
    assert not missing, '%s lacks %s' % (mod.__name__, missing)


def test_pending_list_is_current():
    """Each pending name is still missing from the port, so the list
    shrinks as the later slices port them."""
    for rel, names in PENDING.items():
        assert rel in _jax_modules()
        if names == '*':
            continue
        mod = importlib.import_module(_port_module(rel))
        assert names <= _public_names(rel)
        for name in names:
            assert not hasattr(mod, name)


@pytest.mark.parametrize('rel', _jax_modules(JAX_APPS))
def test_port_has_every_app(rel):
    """Each JAX app has its module under ``pyimsegm_tpu_torch/apps/`` with
    the app's public names (its ``SEGM_PARAMS``, ``main``, argparse and
    method functions)."""
    pending = PENDING_APPS.get(rel, set())
    if pending == '*':
        with pytest.raises(ImportError):
            importlib.import_module(_app_module(rel))
        return
    mod = importlib.import_module(_app_module(rel))
    missing = sorted(n for n in _public_names(rel, JAX_APPS) - pending
                     if not hasattr(mod, n))
    assert not missing, '%s lacks %s' % (mod.__name__, missing)


def _ast_params(func, skip_self=False):
    """Parameter names of a function definition, ``key`` read as
    ``generator``, ``*args`` as ``*name``."""
    a = func.args
    names = [x.arg for x in a.posonlyargs + a.args]
    names = names[1:] if skip_self else names
    if a.vararg:
        names.append('*' + a.vararg.arg)
    names += [x.arg for x in a.kwonlyargs]
    return ['generator' if n == 'key' else n for n in names]


def _signature_faults(rel, root, mod, pending):
    """(name, JAX parameters, port parameters) of each public function or
    class whose port signature does not start with JAX's parameters, or
    adds a trailing one without a default."""
    faults = []
    for node in _tree(rel, root).body:
        name = getattr(node, 'name', None)
        if name is None or name.startswith('_') or name in pending \
                or not hasattr(mod, name):
            continue
        if isinstance(node, ast.FunctionDef):
            want = _ast_params(node)
        elif isinstance(node, ast.ClassDef):
            init = [n for n in node.body if isinstance(n, ast.FunctionDef)
                    and n.name == '__init__']
            if not init:
                continue
            want = _ast_params(init[0], skip_self=True)
        else:
            continue
        params = list(inspect.signature(getattr(mod, node.name))
                      .parameters.values())
        got = [('*' + p.name) if p.kind == p.VAR_POSITIONAL else p.name
               for p in params]
        extra_ok = all(p.default is not p.empty or p.kind in (
            p.VAR_POSITIONAL, p.VAR_KEYWORD) for p in params[len(want):])
        if got[:len(want)] != want or not extra_ok:
            faults.append((node.name, want, got))
    return faults


@pytest.mark.parametrize('rel', _jax_modules())
def test_port_signatures_extend_jax(rel):
    pending = PENDING.get(rel, set())
    if pending == '*' or rel in KERNEL_MODULES:
        return
    mod = importlib.import_module(_port_module(rel))
    assert not _signature_faults(rel, JAX_PKG, mod, pending)


@pytest.mark.parametrize('rel', _jax_modules(JAX_APPS))
def test_app_signatures_extend_jax(rel):
    pending = PENDING_APPS.get(rel, set())
    if pending == '*':
        return
    mod = importlib.import_module(_app_module(rel))
    assert not _signature_faults(rel, JAX_APPS, mod, pending)
