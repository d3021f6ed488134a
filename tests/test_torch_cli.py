"""plz4_tpu_torch.cli and .sparse: the JAX package's CLI and sparse-writer
tests against the port (reference: cmd/plz4 ops + pkg/sparse), and the
device backend through the CLI on the CPU (main(..., device="cpu"))."""

import io
import os

import pytest

import plz4_tpu_torch as plz4
from plz4_tpu_torch import cli
from plz4_tpu_torch.sparse import SparseWriter

from conftest import make_compressible

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def payload_file(tmp_path):
    p = tmp_path / "data.bin"
    p.write_bytes(make_compressible(200_000, seed=8))
    return p


def test_cli_compress_decompress(payload_file, tmp_path):
    src = str(payload_file)
    assert cli.main(["compress", src, "-q"]) == 0
    assert os.path.exists(src + ".lz4")
    out = tmp_path / "restored.bin"
    assert cli.main(["decompress", src + ".lz4", "-o", str(out), "-q", "-f"]) == 0
    assert out.read_bytes() == payload_file.read_bytes()


def test_cli_flags(payload_file, tmp_path):
    src = str(payload_file)
    dst = str(tmp_path / "o.lz4")
    assert cli.main([
        "compress", src, "-o", dst, "-q", "-l", "6", "--bs", "64KB",
        "--bx", "--cs", "-f",
    ]) == 0
    restored = tmp_path / "r.bin"
    assert cli.main(["decompress", dst, "-o", str(restored), "-q"]) == 0
    assert restored.read_bytes() == payload_file.read_bytes()


def test_cli_overwrite_guard(payload_file, tmp_path):
    src = str(payload_file)
    dst = str(tmp_path / "o.lz4")
    assert cli.main(["compress", src, "-o", dst, "-q"]) == 0
    with pytest.raises(SystemExit):
        cli.main(["compress", src, "-o", dst, "-q"])


def test_cli_verify(payload_file, tmp_path, capsys):
    src = str(payload_file)
    dst = str(tmp_path / "o.lz4")
    assert cli.main(["compress", src, "-o", dst, "-q", "--cs"]) == 0
    assert cli.main(["verify", dst]) == 0
    out = capsys.readouterr().out
    assert "OK: 200000 bytes" in out
    assert "content size:      200000" in out


def test_cli_verify_corrupted(payload_file, tmp_path):
    src = str(payload_file)
    dst = tmp_path / "o.lz4"
    assert cli.main(["compress", src, "-o", str(dst), "-q"]) == 0
    raw = bytearray(dst.read_bytes())
    raw[40] ^= 0xFF
    bad = tmp_path / "bad.lz4"
    bad.write_bytes(bytes(raw))
    assert cli.main(["verify", str(bad)]) == 1


def test_cli_verify_header_only(payload_file, tmp_path, capsys):
    src = str(payload_file)
    dst = str(tmp_path / "o.lz4")
    assert cli.main(["compress", src, "-o", dst, "-q", "--bd",
                     "--bs", "64KB"]) == 0
    assert cli.main(["verify", dst, "-s"]) == 0
    out = capsys.readouterr().out
    assert "block independent: False" in out


def test_cli_linked_roundtrip(payload_file, tmp_path):
    src = str(payload_file)
    dst = str(tmp_path / "o.lz4")
    assert cli.main(["compress", src, "-o", dst, "-q", "--bd",
                     "--bs", "64KB"]) == 0
    restored = tmp_path / "r.bin"
    assert cli.main(["decompress", dst, "-o", str(restored), "-q"]) == 0
    assert restored.read_bytes() == payload_file.read_bytes()


def test_cli_dict(tmp_path):
    dict_bytes = make_compressible(5000, seed=99)
    data = dict_bytes[:3000]
    (tmp_path / "dict").write_bytes(dict_bytes)
    (tmp_path / "in").write_bytes(data)
    assert cli.main(["--dict", str(tmp_path / "dict"),
                     "compress", str(tmp_path / "in"), "-q"]) == 0
    assert cli.main(["--dict", str(tmp_path / "dict"),
                     "decompress", str(tmp_path / "in.lz4"),
                     "-o", str(tmp_path / "out"), "-q"]) == 0
    assert (tmp_path / "out").read_bytes() == data


def test_cli_bakeoff(payload_file, capsys):
    assert cli.main(["bakeoff", str(payload_file), "-q"]) == 0
    out = capsys.readouterr().out
    assert "plz4" in out and "ratio" in out
    # the upstream competitor rows appear whenever the reference mount
    # is present (they are the bakeoff's point)
    from plz4_tpu_torch.native import upstream
    if upstream.available():
        assert "upstream" in out


def test_cli_bakeoff_block_mode(payload_file, capsys):
    assert cli.main(["bakeoff", str(payload_file), "-B", "-q"]) == 0
    out = capsys.readouterr().out
    assert "plz4-block" in out and "raw block API" in out


def test_block_size_parse():
    assert cli._parse_block_size("4") == 4
    assert cli._parse_block_size("64KB") == 4
    assert cli._parse_block_size("256KB") == 5
    assert cli._parse_block_size("1MB") == 6
    assert cli._parse_block_size("4MB") == 7


# --- sparse writer ---------------------------------------------------------


class SeekTracker(io.BytesIO):
    """Records seeks so tests can assert hole placement (reference analog:
    preallocWriter fake, sparse/sparse_test.go:18-43)."""

    def __init__(self):
        super().__init__()
        self.seeks = []

    def seek(self, off, whence=0):
        self.seeks.append((off, whence))
        return super().seek(off, whence)


def test_sparse_basic_holes():
    f = SeekTracker()
    w = SparseWriter(f)
    data = b"head" + b"\x00" * 8192 + b"tail"
    w.write(data)
    w.close()
    assert f.seeks  # a hole was seeked over
    assert f.getvalue() == data  # BytesIO zero-fills holes


def test_sparse_non_uint8_memoryview():
    """Regression: non-uint8 buffers are measured in BYTES, not elements
    (an 'I'-typed memoryview previously recorded holes 4x too small)."""
    import array

    f = SeekTracker()
    w = SparseWriter(f)
    payload = array.array("I", [0x64616568] + [0] * 4096 + [0x6C696174])
    w.write(payload)
    w.close()
    assert f.getvalue() == payload.tobytes()


def test_sparse_trailing_hole_commit():
    f = SeekTracker()
    w = SparseWriter(f)
    data = b"x" * 4096 + b"\x00" * 16384
    w.write(data)
    w.close()
    assert f.getvalue() == data
    # trailing hole committed via seek + 1-byte write
    assert f.seeks[-1] == (16384 - 1, 1)


def test_sparse_all_zero():
    f = SeekTracker()
    w = SparseWriter(f)
    w.write(b"\x00" * 100_000)
    w.close()
    assert f.getvalue() == b"\x00" * 100_000


def test_sparse_unaligned_chunks():
    f = SeekTracker()
    w = SparseWriter(f)
    data = (b"a" * 1000 + b"\x00" * 5000 + b"b" * 3000 + b"\x00" * 4096
            + b"c")
    for i in range(0, len(data), 777):
        w.write(data[i : i + 777])
    w.close()
    assert f.getvalue() == data


def test_sparse_decompress_cli(tmp_path):
    data = b"begin" + b"\x00" * 100_000 + b"end"
    (tmp_path / "in").write_bytes(data)
    assert cli.main(["compress", str(tmp_path / "in"), "-q"]) == 0
    assert cli.main(["decompress", str(tmp_path / "in.lz4"),
                     "-o", str(tmp_path / "out"), "-q", "-s"]) == 0
    assert (tmp_path / "out").read_bytes() == data


def test_cli_stdin_stdout(tmp_path, monkeypatch, capsysbinary):
    """stdin -> stdout plumbing (reference: ops/target.go)."""
    import subprocess
    import sys

    data = make_compressible(50_000, seed=60)
    proc = subprocess.run(
        [sys.executable, "-m", "plz4_tpu_torch", "compress", "-q"],
        input=data, capture_output=True, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr.decode()
    comp = proc.stdout
    proc = subprocess.run(
        [sys.executable, "-m", "plz4_tpu_torch", "decompress", "-q"],
        input=comp, capture_output=True, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr.decode()
    assert proc.stdout == data


def test_reader_read_zero():
    import io as iomod

    import plz4_tpu_torch as plz4

    comp = plz4.compress(b"abc")
    r = plz4.Reader(iomod.BytesIO(comp))
    assert r.read(0) == b""
    assert r.read() == b"abc"


# --- the device backend through the CLI --------------------------------------


@pytest.mark.parametrize("flags", [
    [], ["--bs", "64KB", "--bx"], ["--bs", "64KB", "--bd", "-l", "3"],
    ["--bs", "256KB", "-l", "9"]], ids=["default", "64k-bx", "linked-l3",
                                         "256k-l9"])
def test_cli_device_backend_round_trip(payload_file, tmp_path, flags):
    src = str(payload_file)
    dst = str(tmp_path / "o.lz4")
    assert cli.main(["--backend", "device", "compress", src, "-o", dst, "-q",
                     *flags], device="cpu") == 0
    restored = tmp_path / "r.bin"
    assert cli.main(["--backend", "device", "decompress", dst, "-o",
                     str(restored), "-q"], device="cpu") == 0
    data = payload_file.read_bytes()
    assert restored.read_bytes() == data
    assert plz4.decompress(open(dst, "rb").read(), backend="native") == data
    assert cli.main(["--backend", "device", "verify", dst],
                    device="cpu") == 0


def test_cli_device_frame_is_the_api_frame(payload_file, tmp_path):
    src = str(payload_file)
    dst = str(tmp_path / "o.lz4")
    assert cli.main(["--backend", "device", "compress", src, "-o", dst, "-q",
                     "--bs", "64KB", "--bx"], device="cpu") == 0
    assert open(dst, "rb").read() == plz4.compress(
        payload_file.read_bytes(), backend="device", device="cpu",
        block_size_idx=plz4.BLOCK_IDX_64KB, block_checksum=True)


def test_cli_device_dict(tmp_path):
    dict_bytes = make_compressible(5000, seed=98)
    data = dict_bytes[:3000] + make_compressible(9000, seed=97)
    (tmp_path / "dict").write_bytes(dict_bytes)
    (tmp_path / "in").write_bytes(data)
    common = ["--backend", "device", "--dict", str(tmp_path / "dict")]
    assert cli.main([*common, "compress", str(tmp_path / "in"), "-q",
                     "--bs", "64KB"], device="cpu") == 0
    assert cli.main([*common, "decompress", str(tmp_path / "in.lz4"),
                     "-o", str(tmp_path / "out"), "-q"], device="cpu") == 0
    assert (tmp_path / "out").read_bytes() == data


def test_cli_bakeoff_device_row(payload_file, capsys):
    assert cli.main(["bakeoff", str(payload_file), "--device", "-q"],
                    device="cpu") == 0
    rows = [ln.split() for ln in capsys.readouterr().out.splitlines()]
    assert [r[:2] for r in rows if r and r[0] == "device"] == [["device",
                                                                "1"]]


def test_cli_bakeoff_hides_upstream_rows_without_the_reference(
        payload_file, tmp_path, monkeypatch, capsys):
    from plz4_tpu_torch.native import upstream

    monkeypatch.setattr(upstream, "_REF_DIR", str(tmp_path / "absent"))
    monkeypatch.setattr(upstream, "_lib", None)
    monkeypatch.setattr(upstream, "_load_failed", False)
    monkeypatch.setattr(upstream, "_unavailable_reason", None)
    assert not upstream.available()
    assert cli.main(["bakeoff", str(payload_file)]) == 0
    out, err = capsys.readouterr()
    assert "upstream lz4 rows unavailable" in err
    assert "reference sources missing" in err
    assert "upstream" not in out and "plz4" in out
    with pytest.raises(upstream.UpstreamUnavailable):
        upstream.compress(b"abc", 1)


def test_cli_device_backend_needs_a_gpu(payload_file, tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the refusal only applies without one")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--backend", "device", "compress", str(payload_file),
                  "-o", str(tmp_path / "o.lz4"), "-q"])
