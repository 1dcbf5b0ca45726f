"""The one mean-field + ICM body of the port's MRF solvers.

The grid solve of 2D SLIC superpixels (``ops/grid.solve_mrf_grid``), the
supervoxel one (``ops/slic3d.solve_mrf_grid3d``) and the edge-list
``ops/graphcut.solve_mrf`` differ only in how a class field reaches its
neighbours (``message``) and in how a labelling's energy sums
(``energy``); each builds those two and calls :func:`mean_field_icm`.
A leaf module, so that the solvers' modules import it and not each other.
"""

import torch
import torch.nn.functional as F


def mean_field_icm(unary, message, energy, n_mf_iters, n_icm_iters, damping):
    """Damped mean field from ``softmax(-unary)``, its argmin, then
    synchronous ICM keeping the best-energy labelling.  Runs on the device
    of ``unary`` with no host synchronisation.

    :param unary: (..., C) float32 costs over the nodes
    :param message: (..., C) class field -> (..., C) sum over each node's
        neighbours of the weighted pairwise cost of their field
    :param energy: (...) labelling -> scalar energy
    :returns: (best_labels (...) int64, best_e scalar)
    """
    c = unary.shape[-1]
    q = torch.softmax(-unary, dim=-1)
    for _ in range(n_mf_iters):
        q_new = torch.softmax(-(unary + message(q)), dim=-1)
        q = damping * q_new + (1.0 - damping) * q
    labels = torch.argmin(unary + message(q), dim=-1)

    best_labels = labels
    best_e = energy(labels)
    for _ in range(n_icm_iters):
        onehot = F.one_hot(labels, c).to(torch.float32)
        labels = torch.argmin(unary + message(onehot), dim=-1)
        e = energy(labels)
        improved = e < best_e
        best_labels = torch.where(improved, labels, best_labels)
        best_e = torch.where(improved, e, best_e)
    return best_labels, best_e
