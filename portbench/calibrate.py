"""Readings that a cell's limits are set from, and the proof that the
control fails them (not run by the benchmark's own runs).

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        [--control-seeds 4,5,6] [--control-mode tf32] [--out readings.json]

For each seed of ``--seeds``: the cell's check items for that seed (the
items a run with that seed checks), the program's set-up and one warm call,
then the program's capture of each item judged by the plain reference
(``portbench/reference``) and by the configuration's limits (``checks``),
as a run judges them (:func:`portbench.run.judge_items`): the sound
readings, whose largest per number is the lower end of its limit.  For
each seed of ``--control-seeds``: the reference in the configuration's
``control`` precision (or ``--control-mode``, a lower one) in the
program's place, judged the same way: the control readings, whose
smallest per number is the upper end.  Every number of the comparison is
printed, limited or not.

The exit code is 0 only where every sound seed comes out correct and every
control seed comes out not correct.
"""

import argparse
import json
import os
import sys
import time


def readings(cell, seed, control, device='cuda'):
    """([(item position, numbers)], correct) of one seed: the program's
    outputs, or with ``control`` (True, or a precision's name) the
    reference's in the control precision, judged as a run judges them."""
    from portbench.run import check_positions, judge_items
    from portbench.traffic import generate

    config, mix = cell['config'], cell['mix']
    positions = sorted(check_positions(mix, seed))
    items = [generate.make_item(mix, seed, j, device)[0].cpu().numpy()
             for j in positions]
    driver = cell['driver'].Driver(config, device)
    driver.setup()
    if not control:
        driver.call(items[0])
    per_item, _, correct = judge_items(driver, config, items, control)
    return list(zip(positions, per_item)), correct


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seeds', default='')
    parser.add_argument('--control-seeds', default='')
    parser.add_argument('--control-mode',
                        help='another control precision than the '
                        'configuration\'s')
    parser.add_argument('--out')
    args = parser.parse_args(argv)

    from portbench import manifest
    cell = manifest.cell(args.workload)
    control = args.control_mode or True
    record = {'workload': args.workload, 'sound': {}, 'control': {},
              'correct': {'sound': {}, 'control': {}}}
    for kind, seeds in (('sound', args.seeds), ('control', args.control_seeds)):
        for seed in [int(s) for s in seeds.split(',') if s]:
            t0 = time.perf_counter()
            rows, correct = readings(cell, seed,
                                     control if kind == 'control' else False)
            record[kind][seed] = rows
            record['correct'][kind][seed] = correct
            for j, numbers in rows:
                print('%s seed %d item %d: %s' % (kind, seed, j,
                                                  json.dumps(numbers)))
            print('%s seed %d: correct %s (%.1f s)' % (
                kind, seed, correct, time.perf_counter() - t0), flush=True)
    for kind in ('sound', 'control'):
        rows = [n for seed_rows in record[kind].values() for _, n in seed_rows]
        if rows:
            agg = {k: (min(r[k] for r in rows), max(r[k] for r in rows))
                   for k in rows[0]}
            print('%s (min, max) over %d items: %s'
                  % (kind, len(rows), json.dumps(agg)), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, 'w') as fh:
            json.dump(record, fh, indent=1)
    sound_bad = [s for s, ok in record['correct']['sound'].items() if not ok]
    control_ok = [s for s, ok in record['correct']['control'].items() if ok]
    if sound_bad:
        print('sound seeds not correct: %s' % sound_bad, file=sys.stderr)
    if control_ok:
        print('control seeds that come out correct: %s' % control_ok,
              file=sys.stderr)
    return 1 if sound_bad or control_ok else 0


if __name__ == '__main__':
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.exit(main())
