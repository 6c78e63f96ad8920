"""Set-up: from the process's start to the start of the measured window
(imports, kernel build or load, weights, data, warm-up). Host clock."""


def read(run):
    return run.setup_s
