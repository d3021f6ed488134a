"""Device-backend example of the PyTorch/CUDA port: block-parallel LZ4 over a
block mesh.

On a machine with CUDA GPUs the mesh holds every visible GPU:

    python examples/example_device_torch.py

Without one, ask for CPU entries, which run the kernels' plain versions:

    python examples/example_device_torch.py --device cpu
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import plz4_tpu_torch as plz4  # noqa: E402
from plz4_tpu_torch.parallel import dist, use_mesh  # noqa: E402
from plz4_tpu_torch.parallel import mesh as mesh_mod  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda: a mesh over every visible GPU; cpu: four "
                         "CPU entries")
    args = ap.parse_args(argv)
    mesh = (mesh_mod.make_block_mesh() if args.device == "cuda"
            else mesh_mod.make_block_mesh(["cpu"] * 4))
    print(f"mesh: {mesh.size} entries, "
          f"{sorted({str(e.device) for e in mesh.entries})}")

    data = (b"the quick brown fox jumps over the lazy dog " * 6000
            + os.urandom(100000))

    # 1. one-shot with explicit mesh sharding (blocks -> entries)
    comp = dist.compress_sharded(data, mesh=mesh, content_checksum=False,
                                 block_checksum=True, block_size_idx=4)
    out = dist.decompress_sharded(comp, mesh=mesh)
    assert out == data
    print(f"sharded frame: {len(data)} -> {len(comp)} bytes "
          f"(ratio {len(data) / len(comp):.2f}), block checksums computed "
          f"and verified on the device (K7)")

    # 2. the same through the ordinary API: backend='device' under a mesh
    with use_mesh(mesh):
        comp2 = plz4.compress(data, backend="device", level=6,
                              content_checksum=False, block_size_idx=4)
        assert plz4.decompress(comp2, backend="device") == data
    print(f"backend='device' level 6 (the depth-2 chain kernel): "
          f"{len(comp2)} bytes (ratio {len(data) / len(comp2):.2f})")

    # 3. streams interoperate freely with the host codec
    assert plz4.decompress(comp2) == data
    host = plz4.compress(data, level=6)
    with use_mesh(mesh):
        assert plz4.decompress(host, backend="device") == data
    print("host <-> device streams fully interchangeable")


if __name__ == "__main__":
    main()
