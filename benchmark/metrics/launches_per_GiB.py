"""launches_per_GiB (launches_per_GiB.frames, launches_per_GiB.chunks):
kernel launches in the window, summed over the program's `*launches`
counters in its kernel wrappers (ops.encode, ops.encode_mid,
ops.encode_deep, ops.encode_wide, ops.decode, ops.xxh32), per GiB
compressed. The plain versions count nothing."""

from benchmark import readers


def read(run):
    return readers.launches_per_gib(run)
