"""The GMM fit's products on the card (``models/gmm_cuda.py``,
``csrc/gmm_em.cu``) against the plain products, ``models/gmm.
_weighted_sums_plain`` and ``_centred_sums_plain``, which cuBLAS runs there.

The tests marked ``cuda`` need a CUDA device and skip without one; on a
machine with a card and without JAX run ``python3 -m pytest --noconftest
tests/test_torch_gmm_cuda.py`` (the test directory's conftest imports
JAX; nothing here needs it).  The others hold the wrapper's checks, the
routing rule and the EM loop's early end on the CPU.  Whole fits of a
batch of restarts are held to ``REL`` of the plain fit's largest
magnitude, NaN where it is NaN: the kernel sums in cuBLAS's order there.
A fit of one restart sums its first moments in chunks (the split mode),
where cuBLAS runs a split-K GEMM of its own: its fit is held to the plain
fit within the plain fit's own rounding (``ONE_RESTART``).
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pyimsegm_tpu_torch.models import gmm, gmm_cuda
from pyimsegm_tpu_torch.utils import device as dv

from torch_threads import one_torch_thread  # noqa: F401

REL = 1e-6
#: a fit of one restart against the plain fit: at most this many times the
#: plain fit's distance from the float64 fit from the same start (and at
#: least ``REL``); EM carries any change of the sums' order into the fit
#: (~2e-6 on the CPU for exact float64 sums against MKL's)
ONE_RESTART = 2.0
#: (N, D, C, R, how the responsibilities start): the volume's and the
#: slide's fits, one restart from labels (unbatched (N, C) weights), a
#: third of the weights 0, a
#: restart whose first covariance is indefinite, restarts that stop apart,
#: and collinear features whose float32 restarts all break down
CASES = {
    'volume': (107328, 3, 2, 9, 'kmeans'),
    'slide': (57600, 9, 3, 9, 'kmeans'),
    'labels': (5000, 6, 3, 1, 'labels'),
    'zero_weights': (3000, 4, 3, 4, 'kmeans'),
    'not_pd': (3000, 4, 2, 4, 'not_pd'),
    'stops_apart': (4000, 5, 4, 6, 'kmeans'),
    'collinear': (600, 23, 2, 9, 'kmeans'),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


def _data(name, dev):
    """Seeded features (N, D), weights (N,) and starting responsibilities
    (R, N, C) (or (N, C) from labels) of a case, on ``dev``."""
    n, d, c, r, start = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    if name == 'collinear':
        y = rng.integers(0, 2, n)
        lat = rng.normal(size=(n, 3)) + 4.0 * y[:, None]
        x = 30.0 * (lat @ rng.normal(size=(3, d)))
        w = np.ones(n)
    else:
        centres = rng.normal(scale=1.5, size=(c, d))
        mix = np.eye(d) + 0.4 * rng.normal(size=(c, d, d))
        y = rng.integers(0, c, n)
        x = centres[y] + np.einsum('nd,nde->ne', rng.normal(size=(n, d)),
                                   mix[y])
        w = (rng.random(n) >= (1 / 3 if name == 'zero_weights'
                               else 0.05)).astype(np.float64)
        x[w == 0] = 0.0
    x = torch.as_tensor(x.astype(np.float32), device=dev)
    w = torch.as_tensor(w.astype(np.float32), device=dev)
    if start == 'labels':
        return x, w, torch.nn.functional.one_hot(
            torch.as_tensor(y, device=dev), c).to(torch.float32)
    labels = gmm.kmeans_fit(torch.Generator(device=dev).manual_seed(0), x,
                            w, c, n_iter=15, batch=r)[1]
    resp = torch.nn.functional.one_hot(labels, c).to(torch.float32)
    if start == 'not_pd':
        # restart 1: component 0 also takes far samples with weight -1, so
        # its first covariance is indefinite
        far = torch.argsort(-torch.linalg.vector_norm(x, dim=1))[:n // 4]
        resp[1, far, 0] = -1.0
    return x, w, resp


def _plain(monkeypatch):
    """Route every product of the test to the plain functions."""
    monkeypatch.setattr(gmm_cuda, 'fits', lambda *args: False)


def _traced(fn):
    """(fn's result, the counters it counted while tracing)."""
    dv.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    got = dv.counters()
    dv.reset_counters()
    return out, got


def _rel(got, want):
    """max |got - want| / max |want| over the entries where want is not
    NaN; infinite where the NaN entries differ."""
    got = got.detach().double().cpu().numpy()
    want = want.detach().double().cpu().numpy()
    if not np.array_equal(np.isnan(got), np.isnan(want)):
        return np.inf
    ok = ~np.isnan(want)
    if not ok.any():
        return 0.0
    return float(np.max(np.abs(got[ok] - want[ok]))
                 / max(np.max(np.abs(want[ok])), 1e-30))


def _best(scores):
    """The restart ``gmm._select`` takes."""
    return int(torch.argmax(torch.where(torch.isnan(scores), float('-inf'),
                                        scores)))


def _fit(x, w, resp):
    """``_em_fit_f64_if_all_nan`` while tracing: (params, scores, counters)."""
    (params, scores), got = _traced(
        lambda: gmm._em_fit_f64_if_all_nan(x, w, 99, 1e-6, resp))
    return params, scores, got


@pytest.mark.cuda
@pytest.mark.parametrize('name', sorted(CASES))
def test_em_kernel_matches_plain(card, monkeypatch, name):
    x, w, resp = _data(name, card)
    params, scores, counted = _fit(x, w, resp)
    assert counted['em_kernel_runs'] == 1
    with monkeypatch.context() as m:
        _plain(m)
        want_params, want_scores, want_counted = _fit(x, w, resp)
    assert 'em_kernel_runs' not in want_counted
    assert counted['em_active_iters'] == want_counted['em_active_iters']
    assert counted.get('em_refits') == want_counted.get('em_refits')
    exact = gmm._em_fit(x.double(), w.double(), 99, 1e-6, resp.double())
    for got, want, want64 in zip(list(params) + [scores],
                                 list(want_params) + [want_scores],
                                 list(exact[0]) + [exact[1]]):
        assert got.dtype == want.dtype
        limit = REL if resp.dim() == 3 \
            else max(REL, ONE_RESTART * _rel(want, want64))
        assert _rel(got, want) <= limit
    if name == 'collinear':
        assert counted['em_refits'] == 1
        assert params.covs.dtype == torch.float64
    if resp.dim() == 3:
        assert _best(scores) == _best(want_scores)
        assert torch.isfinite(scores[_best(scores)])
    if name == 'not_pd':
        assert torch.isnan(scores[1]) and torch.isnan(want_scores[1])
        assert torch.isfinite(scores[[0, 2, 3]]).all()


@pytest.mark.cuda
@pytest.mark.parametrize('name', ['volume', 'slide'])
def test_products_repeat_and_equal_cublas_bit_for_bit(card, name):
    """At the cells' shapes each product equals cuBLAS's bits, twice."""
    x, w, resp = _data(name, card)
    wr = resp * w[:, None]
    means = gmm._weighted_sums_plain(wr, x) / (wr.sum(1) + 1e-10)[..., None]
    for kernel, plain in (
            (lambda: gmm_cuda.weighted_sums(wr, x),
             lambda: gmm._weighted_sums_plain(wr, x)),
            (lambda: gmm_cuda.centred_sums(x, wr, means),
             lambda: gmm._centred_sums_plain(x, wr, means))):
        first, second, want = kernel(), kernel(), plain()
        assert torch.equal(first.view(torch.int32), second.view(torch.int32))
        assert torch.equal(first, want)


@pytest.mark.cuda
def test_stopped_restarts_are_skipped(card):
    x, w, resp = _data('stops_apart', card)
    wr = resp * w[:, None]
    active = torch.tensor([True, False, True, False, False, True],
                          device=card)
    got = gmm_cuda.weighted_sums(wr, x, active)
    want = gmm_cuda.weighted_sums(wr, x)
    assert torch.equal(got[active], want[active])
    assert not got[~active].any()
    means = want / (wr.sum(1) + 1e-10)[..., None]
    got = gmm_cuda.centred_sums(x, wr, means, active)
    assert torch.equal(got[active], gmm_cuda.centred_sums(x, wr, means)[active])
    assert not got[~active].any()


@pytest.mark.cuda
@pytest.mark.parametrize('name', ['volume', 'slide', 'stops_apart'])
def test_em_kernel_active_iterations_equal_plain(card, monkeypatch, name):
    x, w, resp = _data(name, card)
    iters = _traced(lambda: gmm._em_fit(x, w, 99, 1e-6, resp))[0][2]
    with monkeypatch.context() as m:
        _plain(m)
        want = _traced(lambda: gmm._em_fit(x, w, 99, 1e-6, resp))[0][2]
    assert torch.equal(iters, want)
    if name == 'stops_apart':
        assert len(set(want.tolist())) > 1


@pytest.mark.cuda
@pytest.mark.parametrize('name', ['volume', 'slide', 'zero_weights'])
def test_lloyd_kernel_labels_equal_plain(card, monkeypatch, name):
    """The seeding draws as before (the generator's calls in their order),
    then the Lloyd steps give the plain steps' labels."""
    x, w, _ = _data(name, card)
    n, d, c, r, _ = CASES[name]

    def kmeans():
        return gmm.kmeans_fit(torch.Generator(device=card).manual_seed(1),
                              x, w, c, n_iter=15, batch=r)

    before = gmm_cuda.LAUNCHES['weighted_sums']
    centres, labels = kmeans()
    assert gmm_cuda.LAUNCHES['weighted_sums'] == before + 15
    with monkeypatch.context() as m:
        _plain(m)
        want_centres, want_labels = kmeans()
    assert torch.equal(labels, want_labels)
    assert _rel(centres, want_centres) <= REL


@pytest.mark.cuda
@pytest.mark.parametrize('name', ['volume', 'slide'])
def test_unbatched_products_match_plain(card, name):
    """One fit's (N, C) weights: the split mode's first moments within
    rounding of cuBLAS's unbatched (split-K) product and nearer the exact
    sums than one chain; the centred sums equal to the first restart of a
    batch."""
    x, w, resp = _data(name, card)
    wr = (resp * w[:, None])[0].contiguous()
    got = gmm_cuda.weighted_sums(wr, x)
    assert got.shape == (wr.shape[1], x.shape[1])
    assert _rel(got, gmm._weighted_sums_plain(wr, x)) <= REL
    exact = gmm._weighted_sums_plain(wr.double(), x.double())
    assert _rel(got, exact) <= _rel(gmm_cuda.weighted_sums(wr[None], x)[0],
                                    exact)
    means = got / (wr.sum(0) + 1e-10)[:, None]
    got = gmm_cuda.centred_sums(x, wr, means)
    assert got.shape == (wr.shape[1],) + (x.shape[1],) * 2
    assert _rel(got, gmm._centred_sums_plain(x, wr, means)) <= REL
    assert torch.equal(got, gmm_cuda.centred_sums(x, wr[None],
                                                  means[None])[0])


@pytest.mark.cuda
@pytest.mark.parametrize('n', [1, 1023, 1024, 1025, 5000])
def test_split_mode_chunks_and_skips(card, n):
    """The split mode at chunk edges: within rounding of the float64 sums,
    the same bits twice, 0 for a stopped fit."""
    x, w, resp = _data('labels', card)
    x, wr = x[:n].contiguous(), (resp * w[:, None])[:n].contiguous()
    got = gmm_cuda.weighted_sums(wr, x)
    assert torch.equal(got, gmm_cuda.weighted_sums(wr, x))
    exact = gmm._weighted_sums_plain(wr.double(), x.double())
    assert _rel(got, exact) <= REL
    stopped = gmm_cuda.weighted_sums(wr, x, torch.tensor(False, device=card))
    assert not stopped.any()


@pytest.mark.cuda
def test_fits_launch_the_kernel(card):
    """A fit of 9 restarts launches the weighted sums 15 times in k-means
    and once for each M-step, the centred sums once for each M-step (the
    first and one an iteration, until every restart has stopped); so does
    a fit of one restart from labels, without k-means; a CPU fit launches
    nothing."""
    x, w, resp = _data('labels', card)
    before = dict(gmm_cuda.LAUNCHES)
    gmm.gmm_fit(torch.Generator(device=card).manual_seed(0), x, w, 3,
                n_init=9)
    m_steps = gmm_cuda.LAUNCHES['centred_sums'] - before['centred_sums']
    assert 2 <= m_steps <= 100
    assert gmm_cuda.LAUNCHES['weighted_sums'] - before['weighted_sums'] \
        == 15 + m_steps
    after = dict(gmm_cuda.LAUNCHES)
    gmm.gmm_fit_from_labels(x, resp.argmax(-1), w, 3, max_iter=99)
    m_steps = gmm_cuda.LAUNCHES['centred_sums'] - after['centred_sums']
    assert 2 <= m_steps <= 100
    assert gmm_cuda.LAUNCHES['weighted_sums'] - after['weighted_sums'] \
        == m_steps
    after = dict(gmm_cuda.LAUNCHES)
    gmm.gmm_fit_from_labels(x.cpu(), resp.argmax(-1).cpu(), w.cpu(), 3)
    assert gmm_cuda.LAUNCHES == after


# ------------------------------------------------------------------ CPU ---

def _inputs(n=50, d=3, c=2, r=2):
    g = torch.Generator().manual_seed(0)
    return (torch.randn(n, d, generator=g), torch.ones(n),
            torch.softmax(torch.randn(r, n, c, generator=g), -1))


@pytest.mark.parametrize('bad, match', [
    ('dtype', 'x must be torch.float32'),
    ('weight_dtype', 'w must be torch.float32'),
    ('contiguity', 'x must be contiguous'),
    ('active', 'active must be a contiguous'),
    ('shape', 'the kernel takes'),
    ('device', 'x must be a CUDA tensor'),
    ('unbatched_device', 'x must be a CUDA tensor'),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad, match):
    x, _, w = _inputs(d=33 if bad == 'shape' else 3)
    active = None
    if bad == 'dtype':
        x = x.double()
    if bad == 'weight_dtype':
        w = w.double()
    if bad == 'contiguity':
        x = x.t().contiguous().t()
    if bad == 'active':
        active = torch.ones(2)
    mu = torch.zeros(2, 2, x.shape[1])
    if bad == 'unbatched_device':
        w, mu = w[0], mu[0]
    with pytest.raises(ValueError, match=match):
        gmm_cuda.weighted_sums(w, x, active)
    with pytest.raises(ValueError, match=match):
        gmm_cuda.centred_sums(x, w, mu, active)


@pytest.mark.parametrize('shape, fits', [
    ((1, 1, 1, 2), True), ((107328, 3, 2, 9), True), ((57600, 9, 3, 9), True),
    ((10, 32, 8, 64), True), ((0, 3, 2, 9), False), ((10, 33, 2, 9), False),
    ((10, 3, 9, 9), False), ((10, 0, 2, 9), False), ((10, 3, 0, 9), False),
    ((10, 3, 2, 1), True), ((10, 3, 2, 0), False),
])
def test_routing_rule(shape, fits):
    assert gmm_cuda.shape_fits(*shape) is fits


def test_cpu_and_float64_take_the_plain_products():
    x, _, resp = _inputs()
    assert not gmm_cuda.fits(x, resp)
    assert not gmm_cuda.fits(x.double(), resp.double())
    assert not gmm_cuda.fits(x, resp[0])
    w = torch.ones(x.shape[0])
    before = dict(gmm_cuda.LAUNCHES)
    (params, scores, active), got = _traced(
        lambda: gmm._em_fit(x, w, 7, 1e-6, resp))
    gmm.kmeans_fit(torch.Generator().manual_seed(0), x, w, 2, n_iter=3,
                   batch=2)
    assert gmm_cuda.LAUNCHES == before
    assert got['em_runs'] == 1 and 'em_kernel_runs' not in got
    assert active.shape == (2,)
    wr = resp * w[:, None]
    torch.testing.assert_close(gmm._weighted_sums(wr, x),
                               wr.transpose(-1, -2) @ x, rtol=0, atol=0)


def test_plain_centred_sums_are_the_covariance_numerators():
    x, w, resp = _inputs(n=40, d=4, c=3, r=2)
    wr = resp * w[:, None]
    means = gmm._weighted_sums_plain(wr, x) / wr.sum(1)[..., None]
    got = gmm._centred_sums_plain(x, wr, means)
    diff = x[None, None] - means[:, :, None]                 # (R, C, N, D)
    want = torch.einsum('rcni,rnc,rcnj->rcij', diff, wr, diff)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_cpu_em_ends_once_every_restart_has_stopped(monkeypatch):
    """The loop's early end changes nothing: the same bits as a loop that
    runs all ``max_iter`` iterations, and far fewer steps."""
    x, w, resp = _inputs(n=200, d=3, c=2, r=3)
    polls = []
    poll = gmm._AllStopped.poll

    def counted(self, active):
        polls.append(1)
        return poll(self, active)

    monkeypatch.setattr(gmm._AllStopped, 'poll', counted)
    params, scores, _ = gmm._em_fit(x, torch.ones(200), 99, 1e-6, resp)
    assert len(polls) < 99
    monkeypatch.setattr(gmm._AllStopped, 'poll', lambda self, active: False)
    want_params, want_scores, _ = gmm._em_fit(x, torch.ones(200), 99, 1e-6,
                                              resp)
    for got, want in zip(list(params) + [scores],
                         list(want_params) + [want_scores]):
        assert torch.equal(got, want)
    assert poll(gmm._AllStopped(), torch.tensor([False, False]))
    assert not poll(gmm._AllStopped(), torch.tensor([False, True]))
