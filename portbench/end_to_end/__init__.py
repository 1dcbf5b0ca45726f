"""End-to-end metrics: one module each, named as the metric, whose
``read(window)`` returns the metric's value from an untraced run's window.

``window`` holds ``latencies_s`` (every item's host-clock latency, from
the public call on a host array to its result on the host), ``window_s``
(first call's start to last call's end), ``elements`` (picture elements
of one item) and ``setup_s``.
"""
