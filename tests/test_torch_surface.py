"""Every public top-level name of every module of the JAX package exists
in its counterpart in the port, apart from an explicit pending list.

A module's public names are those it defines (functions, classes,
assignments) and those it re-exports from the package itself; imported
modules and outside packages do not count.  The Pallas kernel modules are
ported as the CUDA kernels of their rows (``PERF.md``): each maps to the
wrapper module of its kernels."""

import ast
import importlib
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(ROOT, 'pyimsegm_tpu')

#: the Pallas modules and the port's wrappers of the same kernels
KERNEL_MODULES = {
    'ops/prep_pallas.py': 'ops/prep_cuda.py',
    'ops/slic_pallas.py': 'ops/slic_cuda.py',
    'ops/grid_pallas.py': 'ops/grid_cuda.py',
    'ops/enforce_pallas.py': 'ops/enforce_cuda.py',
    'ops/connectivity_pallas.py': 'ops/connectivity_cuda.py',
    'ops/slic3d_pallas.py': 'ops/slic3d_cuda.py',
}
#: still to port: whole modules ('*') or names; ROADMAP.md item 9 says
#: which later slice takes each
PENDING = {
    'utils/drawing.py': '*',
    'utils/experiments.py': '*',
    'parallel/tiled.py': '*',
    'native/__init__.py': '*',
    'parallel/__init__.py': {'make_mesh', 'distributed_gmm_em'},
    'parallel/batch.py': {'make_mesh', 'distributed_gmm_em'},
    'graph_cuts.py': {'insert_gc_debug_images'},
}


def _jax_modules():
    out = []
    for dirpath, _, files in os.walk(JAX_PKG):
        for name in files:
            if name.endswith('.py'):
                out.append(os.path.relpath(os.path.join(dirpath, name),
                                           JAX_PKG).replace(os.sep, '/'))
    return sorted(out)


def _is_module(dotted):
    path = os.path.join(ROOT, *dotted.split('.'))
    return os.path.isfile(path + '.py') or os.path.isdir(path)


def _public_names(rel):
    with open(os.path.join(JAX_PKG, rel)) as fp:
        tree = ast.parse(fp.read())
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


def _port_module(rel):
    parts = ['pyimsegm_tpu_torch'] + KERNEL_MODULES.get(rel, rel)[:-3].split(
        '/')
    return '.'.join(parts[:-1] if parts[-1] == '__init__' else parts)


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
    """Each pending name is still missing from the port (or, for
    ``insert_gc_debug_images``, still raises), so the list shrinks as the
    later slices port them."""
    for rel, names in PENDING.items():
        assert rel in _jax_modules()
        if names == '*':
            continue
        mod = importlib.import_module(_port_module(rel))
        assert names <= _public_names(rel)
        for name in names:
            if name == 'insert_gc_debug_images':
                with pytest.raises(NotImplementedError):
                    getattr(mod, name)({}, None, None, None, None, None)
            else:
                assert not hasattr(mod, name)
