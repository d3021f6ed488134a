"""Entry points of the port (the counterparts of the JAX package's
__graft_entry__.py).

entry_array(device=None) -> (step, example_args): __graft_entry__.entry()'s
step over torch tensors: the fused LZ4 round trip (batched block encode,
then batched decode of the encoded rows) through the array path, A1 and A2
(ops/encode_array.py, ops/decode_array.py). Its totals, compressible flags
and validity flag equal the JAX step's exactly.

entry(device=None) -> (step, example_args): the same round trip through
the CUDA kernels K2a and K1 on "cuda" (the default), their plain versions
on "cpu"; the kernels parse as the Pallas kernels do, so its totals are
the kernels', not the array step's.

dryrun_multichip(n, device=None): builds an n-entry block mesh, runs both
round-trip steps with the block batch split over it, and drives the batch
layer under it: plain blocks (kernels and array path), a dictionary with
block checksums, and 96 KiB blocks at the 1 MiB block size. On "cuda" with
fewer than n GPUs the entries repeat the visible GPUs, each with its own
stream; "cpu" gives n CPU entries. Nothing runs on the CPU unless asked
for (the JAX version switches to virtual CPU devices when the platform
has too few).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

from .ops import decode as dec_ops
from .ops import decode_array as dec_arr
from .ops import encode_array as enc_arr
from .parallel import batch as batch_mod
from .parallel import mesh as mesh_mod

BLOCK = 4096


def _example_batch(batch: int, block: int, seed: int = 0):
    """Synthetic compressible blocks (vocabulary text)."""
    rng = np.random.default_rng(seed)
    vocab = [b"lz4 ", b"frame ", b"block ", b"tpu ", b"kernel ", b"match ",
             b"token ", b"hash ", b"the ", b"stream "]
    out = bytearray()
    while len(out) < batch * block:
        out += vocab[int(rng.integers(len(vocab)))]
    arr = np.frombuffer(bytes(out[: batch * block]), dtype=np.uint8)
    data = arr.reshape(batch, block).copy()
    lens = np.full((batch,), block, dtype=np.int32)
    return data, lens


def _round_trip(data: torch.Tensor, lens: torch.Tensor, array: bool = False):
    """Level-1 encode of the (B, N) rows, then decode of the first N + 16
    bytes of each encoded row (the raw row where a row did not shrink):
    (totals, compressible, dec, n_out, ok, good), good marking each row
    that came back intact. The kernels K2a and K1, or with array=True A1
    and A2 (__graft_entry__.entry()'s step)."""
    block = data.shape[1]
    encode = enc_arr.encode_batch if array else batch_mod.dispatch_encode
    decode = dec_arr.decode_batch if array else dec_ops.decode_batch
    out, totals, ok_enc = encode(data, lens, 1)
    compressible = ok_enc & (totals < lens)
    comp = torch.where(compressible[:, None],
                       out[:, : block + dec_ops.ROW_SLACK],
                       F.pad(data, (0, dec_ops.ROW_SLACK)))
    clens = torch.where(compressible, totals, lens)
    dec, n_out, ok = decode(comp, clens, block)
    good = torch.where(compressible,
                       ok & (n_out == lens) & (dec == data).all(dim=1),
                       torch.ones_like(ok))
    return totals, compressible, dec, n_out, ok, good


def _step(device, array: bool):
    dev = batch_mod.resolve_device(device)

    def step(data, lens):
        totals, compressible, *_, good = _round_trip(data, lens, array)
        return totals, compressible, good.all()

    data, lens = _example_batch(batch=4, block=BLOCK)
    return step, (torch.from_numpy(data).to(dev),
                  torch.from_numpy(lens).to(dev))


def entry_array(device=None):
    """__graft_entry__.entry()'s step and example batch on `device`.

    step(data, lens) -> (totals, compressible, all rows intact), equal to
    the JAX step's on the same batch."""
    return _step(device, array=True)


def entry(device=None):
    """The fused round-trip step through the kernels and its example batch
    on `device`.

    step(data, lens) -> (totals, compressible, all rows intact). The
    kernels parse as the Pallas kernels do, not as the JAX step's array
    path: its `compressible`, round trip and flag equal
    __graft_entry__.entry()'s, its `totals` are the kernels'; entry_array
    is the step whose totals equal the JAX step's."""
    return _step(device, array=False)


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"dryrun_multichip: {what}")


def dryrun_multichip(n_devices: int, device=None) -> None:
    """One sharded round-trip step and the batch layer's mesh paths over
    an n_devices-entry mesh; raises on any mismatch."""
    dev = batch_mod.resolve_device(device)
    if dev.type == "cuda":
        gpus = mesh_mod.visible_gpus()
        mesh = mesh_mod.make_block_mesh(
            [gpus[i % len(gpus)] for i in range(n_devices)])
    else:
        mesh = mesh_mod.make_block_mesh([dev] * n_devices)

    B = 2 * n_devices  # blocks split data-parallel over every entry
    block = 1024
    data_np, lens_np = _example_batch(batch=B, block=block)
    # both round-trip steps (kernels, array path), each entry's slice on
    # its device and stream
    for what, array in (("", False), (" array", True)):
        parts = []
        for (lo, hi), e in zip(mesh_mod.shard_bounds(B, mesh), mesh.entries):
            stream = (torch.cuda.stream(e.stream) if e.stream is not None
                      else contextlib.nullcontext())
            with stream:
                parts.append(_round_trip(
                    torch.from_numpy(data_np[lo:hi]).to(e.device),
                    torch.from_numpy(lens_np[lo:hi]).to(e.device), array))
        for e in mesh.entries:
            if e.stream is not None:
                e.stream.synchronize()  # the copies below run elsewhere
        dec = np.concatenate([p[2].cpu().numpy() for p in parts])
        n_out = np.concatenate([p[3].cpu().numpy() for p in parts])
        ok = np.concatenate([p[4].cpu().numpy() for p in parts])
        _check(bool(ok.all()), f"multichip{what} round-trip validity flag "
                               "failed")
        _check(bool((n_out == lens_np).all()), f"multichip{what} round-trip "
                                               "size mismatch")
        _check(bool((dec == data_np).all()), f"multichip{what} round-trip "
                                             "bytes mismatch")

    # the production batch layer (the frame engines' entry point) over the
    # same mesh; the 2-process variant is tests/test_torch_dist_multiprocess
    payload = [bytes(data_np[i]) for i in range(B)]
    dict_ = payload[0][:512]
    with mesh_mod.use_mesh(mesh):
        enc = batch_mod.encode_blocks_begin(payload, 65536).result()
        dec2 = batch_mod.decode_blocks_begin(enc, 65536).result()
        # the array path's batches over the mesh (A1, A2)
        enca = batch_mod.encode_blocks_begin(payload, 65536,
                                             array_path=True).result()
        deca = batch_mod.decode_blocks_begin(enca, 65536,
                                             array_path=True).result()
        # dictionary variants over the mesh (window-prefix encode and the
        # dictionary decode), with block checksums hashed on the device
        encd = batch_mod.encode_blocks_begin(
            payload, 65536, dicts=[dict_] * B, with_checksums=True).result()
        dec3 = batch_mod.decode_blocks_begin(
            [(s, u) for (s, u, _) in encd], 65536, dict_=dict_,
            checksums=[c for (_, _, c) in encd]).result()
    _check(dec2 == payload, "batch-layer mesh round-trip mismatch")
    _check(deca == payload, "batch-layer mesh array round-trip mismatch")
    _check(dec3 == payload, "batch-layer mesh dict round-trip mismatch")

    # the large-block path over the same mesh: 96 KiB blocks run the
    # chunked window-prefix encode and the record decode
    big_np, _ = _example_batch(batch=1, block=96 * 1024, seed=1)
    big = [big_np.tobytes()] * n_devices
    with mesh_mod.use_mesh(mesh):
        encl = batch_mod.encode_blocks_begin(big, 1 << 20).result()
        decl = batch_mod.decode_blocks_begin(encl, 1 << 20).result()
    _check(not any(raw for _, raw in encl), "96 KiB blocks compressed")
    _check(decl == big, "batch-layer mesh large-block round-trip mismatch")


if __name__ == "__main__":
    import sys

    where = sys.argv[1] if len(sys.argv) > 1 else None
    fn, args = entry(where)
    print("entry:", [int(x) for x in fn(*args)[0]])
    fn, args = entry_array(where)
    print("entry_array:", [int(x) for x in fn(*args)[0]])
    dryrun_multichip(2, where)
    print("dryrun_multichip OK")
