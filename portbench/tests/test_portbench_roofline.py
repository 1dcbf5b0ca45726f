"""The yardstick's work counts against ``chip_smoke.py``'s bound figures
(``PERF.md``'s kernel table: rows 1, 2 and 4 at 884x1200, sp_size 35;
row 15 at the 3D workload)."""

import pytest

from portbench import roofline


@pytest.mark.parametrize('row,ms,by', [(1, 0.0057, 'bytes'),
                                       (2, 0.0238, 'ops'),
                                       (4, 0.0033, 'bytes')])
def test_slic_rows_at_884x1200(row, ms, by):
    nbytes, ops = roofline.slic2d_rows(884, 1200, 35)[row]
    assert roofline.least_ms(nbytes, ops) == pytest.approx(ms, abs=5e-5)
    t_bytes = nbytes / roofline.HBM_BYTES_PER_S
    t_ops = ops / roofline.F32_OPS_PER_S
    assert (t_bytes >= t_ops) == (by == 'bytes')


def test_slic3d_row15_at_the_3d_workload():
    nbytes, ops = roofline.slic3d_row15((48, 640, 768), 15, (4, 1, 1))
    assert roofline.least_ms(nbytes, ops) == pytest.approx(1.6707, abs=5e-5)
    assert roofline.grid3d((48, 640, 768), 15, (4, 1, 1))[2] == 12 * 43 * 52


def test_slic_stage_and_step_work():
    config = {'driver': 'sup2d_classif', 'sp_size': 35,
              'dict_features': {'color': [], 'tLM_short': []}}
    mix = {'shape': [884, 1200]}
    rows = roofline.slic2d_rows(884, 1200, 35)
    nbytes, ops = roofline.slic_work(config, mix)
    assert nbytes == sum(b for b, _ in rows.values())
    assert ops == sum(o for _, o in rows.values())
    # 33 filters of 33 x 33 taps on 3 channels, a multiply and an add each
    assert roofline.step_ops(config, mix) == ops + 2 * 884 * 1200 * 3 * 33 \
        * 33 * 33
    config3 = {'driver': 'gray3d_unsup', 'sp_size': 15, 'spacing': [4, 1, 1],
               'dict_features': {'color': []}}
    mix3 = {'shape': [48, 640, 768]}
    assert roofline.step_ops(config3, mix3) == roofline.slic3d_row15(
        (48, 640, 768), 15, (4, 1, 1))[1]


@pytest.mark.parametrize('key,sigmas,orient', [('tLM', 4, 8),
                                               ('tLM_short', 3, 4)])
def test_lm_filter_counts_match_the_banks(key, sigmas, orient):
    from portbench.reference.frozen import descriptors
    bank = descriptors._get_bank('short' if key == 'tLM_short' else 'normal')
    assert roofline.LM_FILTERS[key] == len(bank.kernels) \
        == sigmas * (2 * orient + 3)
    assert bank.kernels.shape[1:] == (33, 33)
