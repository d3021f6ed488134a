"""host_cpu_s_per_GiB: the process's own CPU seconds (user and system,
getrusage) in the window, per GiB compressed."""

from benchmark import readers


def read(run):
    return readers.per_gib(run, run.cpu_s)
