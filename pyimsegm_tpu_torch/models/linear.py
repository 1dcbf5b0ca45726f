"""Linear and neural classifiers on the tensors' device: logistic
regression, a one-hidden-layer MLP, a linear SVM (one-vs-rest squared hinge,
softmax over the margins) and brute-force kNN (port of
``pyimsegm_tpu.models.linear``).

The fits are full-batch Adam with optax's defaults (b1 0.9, b2 0.999, eps
1e-8, eps_root 0), written out so that each step is the reference's update:
``m = b1 m + (1 - b1) g``, ``v = b2 v + (1 - b2) g^2``, ``p -= lr m_hat /
(sqrt(v_hat) + eps)`` with the bias corrections of step t.  The losses are
the reference's, term for term.  A leading fold axis batches a fit over CV
folds (the reference vmaps it): fold ``b`` has its own sample weights and
its own standardised features.  The MLP's He init draws from a
``torch.Generator`` and so differs from the JAX package's, which the port
is held to by accuracy; the other fits draw nothing.
"""

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F


class LinearParams(NamedTuple):
    w: torch.Tensor          # (..., F, C)
    b: torch.Tensor          # (..., C)


class MLPParams(NamedTuple):
    w1: torch.Tensor         # (..., F, H)
    b1: torch.Tensor         # (..., H)
    w2: torch.Tensor         # (..., H, C)
    b2: torch.Tensor         # (..., C)


class KNNParams(NamedTuple):
    x: torch.Tensor          # (N, F) training points
    onehot: torch.Tensor     # (N, C)
    weight: torch.Tensor     # (N,)
    k: int


def _train(loss_fn, params, steps, lr, b1=0.9, b2=0.999, eps=1e-8):
    """``steps`` full-batch Adam steps of ``loss_fn`` from ``params`` (a
    NamedTuple of tensors); optax.adam's update."""
    params = [p.detach().clone() for p in params]
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]
    for t in range(1, steps + 1):
        leaves = [p.requires_grad_(True) for p in params]
        grads = torch.autograd.grad(loss_fn(*leaves), leaves)
        # the bias corrections in f32, as optax forms them
        c1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(t))
        c2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(t))
        with torch.no_grad():
            new = []
            for p, g, mi, vi in zip(params, grads, m, v):
                mi.mul_(b1).add_((1.0 - b1) * g)
                vi.mul_(b2).add_((1.0 - b2) * (g * g))
                upd = -lr * ((mi / c1) / (torch.sqrt(vi / c2) + eps))
                new.append((p + upd).detach())
        params = new
    return params


def _batched(x, sample_weight):
    """(x (B, N, F) f32, w (B, N) f32, batched?) of a fit's inputs."""
    batched = x.ndim == 3 or sample_weight.ndim == 2
    x = x.to(torch.float32)
    w = sample_weight.to(torch.float32)
    nf = max(x.shape[0] if x.ndim == 3 else 1, w.shape[0] if w.ndim == 2
             else 1)
    x = x.expand(nf, *x.shape[-2:]) if x.ndim == 3 else \
        x.expand(nf, *x.shape)
    return x, w.expand(nf, w.shape[-1]), batched


def _unbatch(params, batched):
    return params if batched else type(params)(*(p[0] for p in params))


def _weighted_nll(logits, onehot, w):
    """The reference's data term: ``-sum(ll * w) / max(sum(w), 1)`` per
    fold, summed over the folds (each fold's gradient is its own)."""
    ll = torch.sum(onehot * F.log_softmax(logits, dim=-1), dim=-1)
    return -torch.sum(ll * w, dim=-1) / torch.clamp_min(torch.sum(w, dim=-1),
                                                        1.0)


def logistic_fit(generator, x, y, sample_weight, n_classes, l2=1e-4,
                 steps=300, lr=0.05):
    """Multinomial logistic regression; ``l2 * sum(w^2)`` penalty.  The
    fit starts from zeros, so ``generator`` (JAX's ``key``) is unused.

    :param x: (N, F) or (B, N, F); :param sample_weight: (N,) or (B, N)
    """
    x, w, batched = _batched(x, sample_weight)
    nf, _, f = x.shape
    onehot = F.one_hot(y.to(torch.int64), n_classes).to(torch.float32)
    zeros = LinearParams(torch.zeros((nf, f, n_classes), device=x.device),
                         torch.zeros((nf, n_classes), device=x.device))

    def loss(pw, pb):
        logits = x @ pw + pb[:, None, :]
        return torch.sum(_weighted_nll(logits, onehot, w)
                         + l2 * torch.sum(pw ** 2, dim=(1, 2)))

    return _unbatch(LinearParams(*_train(loss, zeros, steps, lr)), batched)


def logistic_predict_proba(params: LinearParams, x):
    """(N, C) softmax of the linear scores ((B, N, C) batched)."""
    x = x.to(torch.float32)
    if params.w.ndim == 3:
        return torch.softmax(x @ params.w + params.b[:, None, :], dim=-1)
    return torch.softmax(x @ params.w + params.b, dim=-1)


def mlp_init(generator, f, hidden, n_classes, n_folds=None):
    """He-initialised :class:`MLPParams` (``normal * sqrt(2 / fan_in)``,
    zero biases), with a leading (n_folds,) axis when given."""
    lead = () if n_folds is None else (n_folds,)
    dev = generator.device
    w1 = torch.randn(lead + (f, hidden), generator=generator, device=dev) \
        * torch.sqrt(torch.tensor(2.0 / f))
    w2 = torch.randn(lead + (hidden, n_classes), generator=generator,
                     device=dev) * torch.sqrt(torch.tensor(2.0 / hidden))
    return MLPParams(w1, torch.zeros(lead + (hidden,), device=dev), w2,
                     torch.zeros(lead + (n_classes,), device=dev))


def mlp_train(params: MLPParams, x, y, sample_weight, n_classes, l2=1e-5,
              steps=500, lr=0.01):
    """The MLP fit from given initial parameters (batched as ``x``)."""
    x, w, batched = _batched(x, sample_weight)
    if params.w1.ndim == 2:
        params = MLPParams(*(p[None] for p in params))
    onehot = F.one_hot(y.to(torch.int64), n_classes).to(torch.float32)

    def loss(w1, b1, w2, b2):
        h = torch.relu(x @ w1 + b1[:, None, :])
        logits = h @ w2 + b2[:, None, :]
        reg = l2 * (torch.sum(w1 ** 2, dim=(1, 2))
                    + torch.sum(w2 ** 2, dim=(1, 2)))
        return torch.sum(_weighted_nll(logits, onehot, w) + reg)

    return _unbatch(MLPParams(*_train(loss, params, steps, lr)), batched)


def mlp_fit(generator, x, y, sample_weight, n_classes, hidden=64, l2=1e-5,
            steps=500, lr=0.01):
    """One-hidden-layer ReLU network, He init from ``generator``."""
    n_folds = x.shape[0] if x.ndim == 3 else (
        sample_weight.shape[0] if sample_weight.ndim == 2 else None)
    init = mlp_init(generator, x.shape[-1], hidden, n_classes, n_folds)
    return mlp_train(init, x, y, sample_weight, n_classes, l2=l2, steps=steps,
                     lr=lr)


def mlp_predict_proba(params: MLPParams, x):
    """(N, C) softmax of the network's logits ((B, N, C) batched)."""
    x = x.to(torch.float32)
    if params.w1.ndim == 3:
        h = torch.relu(x @ params.w1 + params.b1[:, None, :])
        return torch.softmax(h @ params.w2 + params.b2[:, None, :], dim=-1)
    h = torch.relu(x @ params.w1 + params.b1)
    return torch.softmax(h @ params.w2 + params.b2, dim=-1)


def linear_svm_fit(generator, x, y, sample_weight, n_classes, c_reg=1.0,
                   steps=400, lr=0.05):
    """One-vs-rest squared-hinge linear SVM; ``0.5 * sum(w^2) / N`` with N
    the rows, zero-weight ones included.  ``generator`` (JAX's ``key``) is
    unused: the fit starts from zeros."""
    x, w, batched = _batched(x, sample_weight)
    nf, n, f = x.shape
    targets = 2.0 * F.one_hot(y.to(torch.int64),
                              n_classes).to(torch.float32) - 1.0
    zeros = LinearParams(torch.zeros((nf, f, n_classes), device=x.device),
                         torch.zeros((nf, n_classes), device=x.device))

    def loss(pw, pb):
        margins = x @ pw + pb[:, None, :]
        hinge = torch.clamp_min(1.0 - targets * margins, 0.0) ** 2
        data = torch.sum(hinge * w[..., None], dim=(1, 2)) \
            / torch.clamp_min(torch.sum(w, dim=-1), 1.0)
        return torch.sum(c_reg * data
                         + 0.5 * torch.sum(pw ** 2, dim=(1, 2)) / n)

    return _unbatch(LinearParams(*_train(loss, zeros, steps, lr)), batched)


def knn_fit(x, y, sample_weight, n_classes, k=5):
    return KNNParams(x.to(torch.float32),
                     F.one_hot(y.to(torch.int64), n_classes).to(torch.float32),
                     sample_weight.to(torch.float32), k)


def _knn_proba(train_x, onehot, weight, q, k):
    """Votes of the k nearest training points of weight > 0, by squared
    distances ``|q|^2 - 2 q.x + |x|^2`` as the reference writes them."""
    d2 = (torch.sum(q * q, 1)[:, None] - 2.0 * (q @ train_x.T)
          + torch.sum(train_x * train_x, 1)[None, :])
    d2 = torch.where(weight[None, :] > 0, d2, float('inf'))
    idx = torch.topk(-d2, k, dim=1).indices
    votes = torch.sum(onehot[idx], dim=1)
    return votes / torch.clamp_min(torch.sum(votes, 1, keepdim=True), 1e-10)


def knn_predict_proba(params: KNNParams, x):
    return _knn_proba(params.x, params.onehot, params.weight,
                      x.to(torch.float32), params.k)
