"""Segmentation agreement and classification metrics (port of
``pyimsegm_tpu.utils.metrics``), on the host in numpy.  Inputs may be numpy
arrays or tensors."""

import numpy as np
import torch


def _flat_int(labels):
    if isinstance(labels, torch.Tensor):
        labels = labels.detach().cpu().numpy()
    return np.asarray(labels).ravel().astype(np.int64)


def contingency_table(labels_a, labels_b, num_a, num_b):
    """(num_a, num_b) co-occurrence counts of two flat label vectors."""
    a = _flat_int(labels_a)
    b = _flat_int(labels_b)
    counts = np.bincount(a * num_b + b, minlength=num_a * num_b)
    return counts.reshape(num_a, num_b).astype(np.float64)


def segment_digest(labels, num_segments):
    """(K, 2) int64 [element count, sum of flat element indices] per label.
    Two labelings of one array give the same row to a label whose element
    set they agree on; a row that differs marks a label they disagree on."""
    flat = _flat_int(labels)
    count = np.bincount(flat, minlength=num_segments)[:num_segments]
    # float64 sums of integers below 2**53 are exact
    index = np.arange(flat.size, dtype=np.float64)
    index_sum = np.bincount(flat, weights=index,
                            minlength=num_segments)[:num_segments]
    return np.stack([count, index_sum.astype(np.int64)], axis=-1)


def _comb2(x):
    return x * (x - 1.0) / 2.0


def adjusted_rand_score(labels_a, labels_b, num_a=None, num_b=None):
    """Adjusted Rand score of two labelings (sklearn's definition)."""
    la = _flat_int(labels_a)
    lb = _flat_int(labels_b)
    if num_a is None:
        num_a = int(la.max()) + 1
    if num_b is None:
        num_b = int(lb.max()) + 1
    c = contingency_table(la, lb, num_a, num_b)
    n = c.sum()
    sum_comb = _comb2(c).sum()
    a = _comb2(c.sum(axis=1)).sum()
    b = _comb2(c.sum(axis=0)).sum()
    expected = a * b / max(_comb2(n), 1.0)
    denom = 0.5 * (a + b) - expected
    if denom == 0:
        return 1.0
    return float((sum_comb - expected) / denom)


def accuracy(labels_true, labels_pred):
    """Share of equal labels."""
    return float(np.mean(_flat_int(labels_true) == _flat_int(labels_pred)))


def confusion_matrix(labels_true, labels_pred, nb_labels=None):
    """(L, L) f32 counts, true label by row."""
    t, p = _flat_int(labels_true), _flat_int(labels_pred)
    if nb_labels is None:
        nb_labels = int(max(t.max(), p.max())) + 1
    return contingency_table(t, p, nb_labels, nb_labels).astype(np.float32)


def precision_recall_f1(labels_true, labels_pred, nb_labels=None,
                        average='macro'):
    """Per-class precision, recall and F1, or their 'macro' or 'weighted'
    averages."""
    cm = confusion_matrix(labels_true, labels_pred, nb_labels)
    tp = np.diag(cm)
    support = cm.sum(axis=1)
    pred_cnt = cm.sum(axis=0)
    with np.errstate(divide='ignore', invalid='ignore'):
        prec = np.where(pred_cnt > 0, tp / pred_cnt, 0.0)
        rec = np.where(support > 0, tp / support, 0.0)
        f1 = np.where(prec + rec > 0, 2 * prec * rec / (prec + rec), 0.0)
    if average == 'macro':
        w = np.ones_like(support) / len(support)
    elif average == 'weighted':
        w = support / max(support.sum(), 1.0)
    else:
        return prec, rec, f1
    return float(prec @ w), float(rec @ w), float(f1 @ w)


def compute_classif_metrics(labels_true, labels_pred, nb_labels=None):
    """ARS, accuracy, the confusion matrix and the macro and weighted
    precision, recall and F1, under the reference's names."""
    p_ma, r_ma, f_ma = precision_recall_f1(labels_true, labels_pred,
                                           nb_labels, 'macro')
    p_w, r_w, f_w = precision_recall_f1(labels_true, labels_pred, nb_labels,
                                        'weighted')
    return {
        'ARS': adjusted_rand_score(labels_true, labels_pred),
        'accuracy': accuracy(labels_true, labels_pred),
        'confusion': confusion_matrix(labels_true, labels_pred,
                                      nb_labels).tolist(),
        'precision_macro': p_ma, 'recall_macro': r_ma, 'f1_macro': f_ma,
        'precision_weighted': p_w, 'recall_weighted': r_w, 'f1_weighted': f_w,
    }
