"""Batched and multi-card execution of the segmentation pipeline (port of
``pyimsegm_tpu.parallel.batch``).

One card: the batch is a loop over the leading dimension on the current
stream, each image through the same kernels as the single-image call (the
JAX package ``vmap``s the per-image pipeline).

Several cards: SPMD with one process per card, the PyTorch form of JAX's
``shard_map``.  A mesh is a 1D ``torch.distributed.device_mesh.DeviceMesh``
(:func:`make_mesh`); every rank calls the same function with the same
whole inputs, works on its own share of the batch, and the shared results
are reduced (``all_reduce``) or gathered (``all_gather``) over the mesh's
process group, so every rank returns the full result.  Launch with
``torchrun --nproc-per-node N``; without a launcher :func:`make_mesh`
starts a world of one.
"""

import os

import numpy as np
import torch
import torch.distributed as dist

from pyimsegm_tpu_torch import pipelines
from pyimsegm_tpu_torch.models import gmm as gmm_mod
from pyimsegm_tpu_torch.ops import graphcut
from pyimsegm_tpu_torch.ops import slic as slic_ops
from pyimsegm_tpu_torch.ops.grid import grid_lookup
from pyimsegm_tpu_torch.utils.device import host_array

#: process-group backend of each mesh device type
BACKENDS = {'cuda': 'cpu:gloo,cuda:nccl', 'cpu': 'gloo'}


def _init_world(device_type):
    """Start the default process group unless one exists: from the
    environment where a launcher such as ``torchrun`` set it, else a world
    of one over an in-process store.  On CUDA each rank takes the card of
    its local rank."""
    if device_type not in BACKENDS:
        raise ValueError('mesh device must be cuda or cpu, got %r'
                         % device_type)
    if device_type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError('no CUDA device for a cuda mesh; pass '
                               'device="cpu" for a gloo mesh')
    if not dist.is_initialized():
        backend = BACKENDS[device_type]
        if 'RANK' in os.environ and 'WORLD_SIZE' in os.environ:
            dist.init_process_group(backend)
        else:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                    world_size=1)
    if device_type == 'cuda':
        local = int(os.environ.get('LOCAL_RANK', dist.get_rank()))
        torch.cuda.set_device(local % torch.cuda.device_count())


def make_mesh(n_devices=None, axis_name='batch', device='cuda'):
    """1D device mesh over the first ``n_devices`` ranks of the world (all
    of them by default), its one dimension named ``axis_name``.  Starts the
    default process group when none exists (:func:`_init_world`): NCCL for
    CUDA tensors (gloo for host tensors) on a ``cuda`` mesh, gloo on a
    ``cpu`` mesh."""
    from torch.distributed.device_mesh import DeviceMesh
    device_type = torch.device(device).type
    _init_world(device_type)
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError('mesh of %d ranks in a world of %d' % (n, world))
    return DeviceMesh(device_type, torch.arange(n),
                      mesh_dim_names=(axis_name,))


def mesh_device(mesh):
    """The device this rank works on for ``mesh``."""
    if mesh.device_type == 'cuda':
        return torch.device('cuda', torch.cuda.current_device())
    return torch.device(mesh.device_type)


def mesh_rank(mesh):
    """(this rank's index along the 1D mesh, the mesh's size); raises on a
    rank outside the mesh."""
    if mesh.get_coordinate() is None:
        raise ValueError('rank %d is not in the mesh' % dist.get_rank())
    return mesh.get_local_rank(0), mesh.size()


def all_gather_cat(tensor, mesh):
    """Every rank's ``tensor`` (same shape on each) concatenated along the
    first dimension in mesh order, on every rank."""
    parts = [torch.empty_like(tensor) for _ in range(mesh.size())]
    dist.all_gather(parts, tensor.contiguous(), group=mesh.get_group(0))
    return torch.cat(parts)


def _segment_one(image, model, *, cfg, feats_spec, gc_regul, gc_edge_type,
                 compactness):
    """One image: enforced SLIC + features, GMM proba, grid MRF, and one
    lookup that upsamples the hard labels and the soft proba together."""
    labels, features, _counts, centers = pipelines._slic_features_core(
        image, cfg, feats_spec, compactness)
    proba = model.predict_proba(features)
    graph_labels = graphcut.segment_graph_cut_general(
        labels, proba, cfg.n_segments, image=image.to(torch.float32),
        features=features, gc_regul=gc_regul, edge_type=gc_edge_type,
        grid_ctx=(labels, cfg), centers=centers)
    table = torch.cat([graph_labels[:, None].to(torch.float32), proba],
                      dim=-1)
    up = grid_lookup(table, labels, cfg)
    return up[..., 0].to(torch.int32), up[..., 1:]


def segment_images_batch(images, model, dict_features, sp_size=30,
                         sp_regul=0.2, gc_regul=1.0, gc_edge_type='model',
                         mesh=None):
    """Segment a stack of same-shape images with a fitted model, on the
    model's device.

    :param images: (B, H, W, 3) array or tensor; with a mesh every rank
        passes the whole stack
    :param mesh: optional 1D mesh (:func:`make_mesh`) of the model's device
        type; each rank segments its ``B / size`` consecutive images and
        the results are gathered, so B must divide evenly
    :returns: (segms (B, H, W) int32, probs (B, H, W, C) f32) numpy arrays,
        the whole batch on every rank
    """
    images = pipelines._to_model_device(images, model).to(torch.float32)
    b, h, w = images.shape[:3]
    if mesh is not None:
        if mesh.device_type != images.device.type:
            raise ValueError('mesh of %s, model on %s'
                             % (mesh.device_type, images.device))
        rank, size = mesh_rank(mesh)
        if b % size:
            raise ValueError('a batch of %d images does not split over %d '
                             'ranks' % (b, size))
        images = images[rank * (b // size):(rank + 1) * (b // size)]
    cfg = slic_ops.slic_config(h, w, sp_size)
    m = slic_ops.compactness_from_regul(sp_size, sp_regul)
    spec = pipelines._features_spec(dict_features)
    outs = [_segment_one(img, model, cfg=cfg, feats_spec=spec,
                         gc_regul=float(gc_regul), gc_edge_type=gc_edge_type,
                         compactness=m) for img in images]
    segms = torch.stack([o[0] for o in outs])
    probs = torch.stack([o[1] for o in outs])
    if mesh is not None:
        segms, probs = all_gather_cat(segms, mesh), all_gather_cat(probs, mesh)
    return segms.cpu().numpy(), probs.cpu().numpy()


# ------------------------------------------------------- distributed EM ----

@gmm_mod.full_precision
def distributed_gmm_em(features, sample_weight, n_components, mesh,
                       n_iter=30, reg_covar=1e-6, seed=0):
    """Fit one GMM over features split across a device mesh: the group
    model's training step.  Each rank takes its ``B / size`` images'
    features; each EM iteration computes local responsibilities and reduces
    the sufficient statistics over the mesh: the counts and sums in one
    ``all_reduce``, then the centred second moments in another (the
    one-pass E[xx] - mm form cancels for low-mass components and goes
    non-PSD).  Components with a count below 1e-3 keep their previous
    parameters, and the weights are floored at 1e-8.

    The start is drawn on the host as in the JAX package: ``n_components``
    weighted samples picked by ``np.random.default_rng(seed)``, one shared
    diagonal covariance.

    :param features: (B, K, D) per-image padded feature stacks (the whole
        stack on every rank)
    :param sample_weight: (B, K) weights (0 for padded slots)
    :returns: :class:`~pyimsegm_tpu_torch.models.gmm.GMMParams` on the
        mesh's device, equal on every rank
    """
    feats = host_array(features).astype(np.float32)
    wts = host_array(sample_weight).astype(np.float32)
    b, _k, d = feats.shape
    c = n_components
    rank, size = mesh_rank(mesh)
    if b % size:
        raise ValueError('a batch of %d images does not split over %d ranks'
                         % (b, size))
    dev = mesh_device(mesh)
    group = mesh.get_group(0)

    flat = feats.reshape(-1, d)
    wflat = wts.reshape(-1)
    sel = np.nonzero(wflat > 0)[0]
    rng = np.random.default_rng(seed)
    pick = rng.choice(sel, size=c, replace=len(sel) < c)
    var0 = np.float32(np.var(flat[sel], axis=0).mean() + reg_covar)
    cov0 = np.eye(d, dtype=np.float32) * var0
    params = gmm_mod.GMMParams(
        torch.full((c,), 1.0 / c, dtype=torch.float32, device=dev),
        torch.as_tensor(flat[pick], device=dev),
        torch.as_tensor(np.tile(cov0[None], (c, 1, 1)), device=dev))

    bl = b // size
    x = torch.as_tensor(feats[rank * bl:(rank + 1) * bl].reshape(-1, d),
                        device=dev)
    w = torch.as_tensor(wts[rank * bl:(rank + 1) * bl].reshape(-1),
                        device=dev)
    eye = torch.eye(d, dtype=torch.float32, device=dev)
    for _ in range(n_iter):
        resp = gmm_mod.gmm_predict_proba(params, x) * w[:, None]
        stats = torch.cat([torch.sum(resp, dim=0)[:, None], resp.T @ x],
                          dim=1)                                # (C, 1 + D)
        dist.all_reduce(stats, op=dist.ReduceOp.SUM, group=group)
        nk, sx = stats[:, 0], stats[:, 1:]
        nk_safe = torch.clamp_min(nk, 1e-10)
        means = sx / nk_safe[:, None]
        xc = x[:, None, :] - means[None]                        # (N, C, D)
        sxx = torch.einsum('nc,ncd,nce->cde', resp, xc, xc)
        dist.all_reduce(sxx, op=dist.ReduceOp.SUM, group=group)
        covs = sxx / nk_safe[:, None, None] + reg_covar * eye
        weights = nk / torch.sum(nk)
        dead = nk < 1e-3
        means = torch.where(dead[:, None], params.means, means)
        covs = torch.where(dead[:, None, None], params.covs, covs)
        weights = torch.clamp_min(weights, 1e-8)
        params = gmm_mod.GMMParams(weights / torch.sum(weights), means, covs)
    return params
