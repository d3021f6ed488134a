"""setup_s: seconds from the process's start to the window's: torch and
CUDA, the kernels from the program's build cache (built on a first run),
the payload from the seed, the warm call at the cell's shapes."""


def read(run):
    return run.setup_s
