"""Share (%) of the SLIC stage's roofline: the least time of its work
(``portbench.roofline.slic_work``: rows 1, 2 and 4 in 2D, row 15 in 3D,
from the item's shape) over the device busy ms of pyimsegm:slic."""

from portbench import roofline
from portbench.metrics import busy_ms_per_item


def read(ctx):
    busy = busy_ms_per_item(ctx, ('slic',))
    if busy is None:
        return None
    least = roofline.least_ms(*roofline.slic_work(ctx['config'], ctx['mix']))
    return 100.0 * least / busy
