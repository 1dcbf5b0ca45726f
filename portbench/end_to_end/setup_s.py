"""Seconds from the process's start to the first timed item: imports, the
kernel build (first run in a checkout only), the pool, the model and the
warm calls."""


def read(window):
    return window['setup_s']
