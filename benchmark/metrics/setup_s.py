"""Seconds from the process's start to the window's: imports, the kernels'
build (a checkout's first run) or load, weights and images made from the
seed, the recipe's preparation and the warm-up of the cell's own shapes."""


def read(rec):
    return rec['setup_s']
