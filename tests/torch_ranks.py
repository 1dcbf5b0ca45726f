"""Rank workers of the port's multi-rank CPU tests.

:func:`spawn` starts ``world`` processes with ``torch.multiprocessing``
(spawn), each joins a gloo world through a ``FileStore`` under the test's
temporary folder, runs one worker function of this module on a 1D CPU
mesh and writes its result to a file; the results come back in rank
order.  The workers import the port only, never JAX, so each rank starts
in a couple of seconds.
"""

import os
import pickle

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _entry(rank, fn, world, folder, args):
    torch.set_num_threads(1)
    dist.init_process_group(
        'gloo', store=dist.FileStore(os.path.join(folder, 'store'), world),
        rank=rank, world_size=world)
    try:
        out = fn(*args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(folder, 'rank%d.pkl' % rank), 'wb') as fh:
        pickle.dump(out, fh)


def spawn(fn, world, folder, *args):
    """Run ``fn(*args)`` on each of ``world`` gloo ranks; returns the list
    of their results."""
    folder = str(folder)
    os.makedirs(folder, exist_ok=True)
    mp.spawn(_entry, args=(fn, world, folder, args), nprocs=world, join=True)
    out = []
    for rank in range(world):
        with open(os.path.join(folder, 'rank%d.pkl' % rank), 'rb') as fh:
            out.append(pickle.load(fh))
    return out


def _mesh(axis_name):
    from pyimsegm_tpu_torch.parallel.batch import make_mesh
    return make_mesh(axis_name=axis_name, device='cpu')


def gmm_em(features, weights, n_components, n_iter, seed):
    """``distributed_gmm_em`` on a mesh of the whole world."""
    from pyimsegm_tpu_torch.parallel.batch import distributed_gmm_em
    params = distributed_gmm_em(features, weights, n_components,
                                _mesh('batch'), n_iter=n_iter, seed=seed)
    return {k: v.numpy() for k, v in params._asdict().items()}


def batch(images, model_arrays, features, kwargs):
    """``segment_images_batch`` with and without the mesh, and the error
    an uneven batch raises."""
    from pyimsegm_tpu_torch.models.class_model import class_model_from_numpy
    from pyimsegm_tpu_torch.parallel.batch import segment_images_batch
    model = class_model_from_numpy(model_arrays)
    mesh = _mesh('batch')
    got = segment_images_batch(images, model, features, mesh=mesh, **kwargs)
    plain = segment_images_batch(images, model, features, **kwargs)
    try:
        segment_images_batch(images[:len(images) - 1], model, features,
                             mesh=mesh, **kwargs)
        uneven = None
    except ValueError as exc:
        uneven = str(exc)
    return got, plain, uneven


def tiled(slic_image, pipe_image, sp_size, sp_regul, gc_regul, features,
          n_classes):
    """``slic_segment_sharded`` of one image and the tiled pipeline of
    another, on a mesh of the whole world named ``'rows'``."""
    from pyimsegm_tpu_torch.parallel import tiled as tt
    mesh = _mesh('rows')
    labels = tt.slic_segment_sharded(slic_image, sp_size, sp_regul,
                                     mesh=mesh)
    segm, soft = tt.pipe_color2d_slic_features_model_graphcut_tiled(
        pipe_image, n_classes, features, sp_size=sp_size, sp_regul=sp_regul,
        gc_regul=gc_regul, mesh=mesh)
    return labels, segm, soft


def mesh_facts():
    """What ``make_mesh`` gives on this rank: the mesh's size and
    dimension name, this rank's index, the error of a mesh larger than the
    world, and whether a mesh of the first rank alone admits this rank."""
    from pyimsegm_tpu_torch.parallel.batch import make_mesh, mesh_rank
    mesh = make_mesh(axis_name='rows', device='cpu')
    try:
        make_mesh(dist.get_world_size() + 1, device='cpu')
        too_big = None
    except ValueError as exc:
        too_big = str(exc)
    first = make_mesh(1, device='cpu')
    try:
        in_first = mesh_rank(first)
    except ValueError:
        in_first = None
    return (mesh.size(), mesh.mesh_dim_names, mesh_rank(mesh), too_big,
            in_first)
