"""The port's host <-> device I/O pipeline on the CPU: the threaded
prefetch loader, the chunk streamer and the background writer, beside
the JAX package's on the same files."""

import os
import threading

import numpy as np
import pytest
import torch

from astrophotography_tpu.parallel import pipeline as jpipe
from astrophotography_tpu_torch.io.fits import Header, read_image, write_image
from astrophotography_tpu_torch.parallel import (AsyncWriter, PrefetchLoader,
                                                 stream_stacks)

torch.set_num_threads(1)

N = 10


@pytest.fixture()
def fits_files(tmp_path):
    rng = np.random.default_rng(0)
    paths = []
    for i in range(N):
        data = rng.integers(0, 65536, (24, 32)).astype(np.uint16)
        data[0, 0] = i
        hdr = Header()
        hdr["FRAMEIDX"] = i
        p = str(tmp_path / f"f{i:02d}.fits")
        write_image(p, data, hdr)
        paths.append(p)
    return paths


@pytest.mark.parametrize("depth,workers", [(1, 1), (3, 3), (20, 2)])
def test_prefetch_loader_keeps_order(fits_files, depth, workers):
    loader = PrefetchLoader(fits_files, depth=depth, workers=workers)
    assert len(loader) == N
    out = list(loader)
    ref = list(jpipe.PrefetchLoader(fits_files, depth=depth,
                                    workers=workers))
    assert [p for p, _, _ in out] == fits_files
    for i, ((_, data, hdr), (_, rdata, rhdr)) in enumerate(zip(out, ref)):
        assert hdr["FRAMEIDX"] == i and data[0, 0] == i
        np.testing.assert_array_equal(data, rdata)
        assert list(hdr._cards) == list(rhdr._cards)
    assert list(PrefetchLoader([])) == []


def test_prefetch_loader_takes_a_reader(fits_files):
    def reader(path):
        return read_image(path, as_float32=False)
    for _, data, _ in PrefetchLoader(fits_files[:3], reader=reader):
        assert data.dtype == np.uint16


def test_loader_exception_reaches_the_consumer(fits_files, tmp_path):
    bad = str(tmp_path / "broken.fits")
    with open(bad, "wb") as fh:
        fh.write(b"not a FITS file at all".ljust(2880))
    paths = fits_files[:4] + [bad] + fits_files[4:]
    seen = []
    with pytest.raises(ValueError, match="not a FITS file"):
        for path, _, _ in PrefetchLoader(paths, depth=2, workers=2):
            seen.append(path)
    assert seen == fits_files[:4]
    with pytest.raises(ValueError, match="not a FITS file"):
        for _ in stream_stacks(paths, chunk=3, device="cpu"):
            pass


@pytest.mark.parametrize("chunk", [4, 5, 16])
def test_stream_stacks_chunks(fits_files, chunk):
    chunks = list(stream_stacks(fits_files, chunk=chunk, depth=2, workers=2,
                                device="cpu"))
    ref = list(jpipe.stream_stacks(fits_files, chunk=chunk, depth=2,
                                   workers=2))
    assert [c[1].shape[0] for c in chunks] == [c[1].shape[0] for c in ref]
    assert [n for c in chunks for n in c[0]] == fits_files
    for (names, stack, headers), (rnames, rstack, _) in zip(chunks, ref):
        assert isinstance(stack, torch.Tensor)
        assert stack.dtype == torch.float32 and stack.device.type == "cpu"
        assert names == rnames and len(headers) == len(names)
        np.testing.assert_array_equal(stack.numpy(), np.asarray(rstack))
    flat_headers = [h for c in chunks for h in c[2]]
    assert [h["FRAMEIDX"] for h in flat_headers] == list(range(N))
    assert list(stream_stacks([], device="cpu")) == []


def test_stream_stacks_defaults_to_the_card(fits_files):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    with pytest.raises(RuntimeError, match="cuda"):
        next(stream_stacks(fits_files))


def test_async_writer_roundtrip_and_close_flushes(tmp_path):
    gate = threading.Event()
    real = write_image
    import astrophotography_tpu_torch.parallel.pipeline as tpipe

    def slow_write(path, data, header=None):
        gate.wait(5.0)
        real(path, data, header)
    tpipe.write_image = slow_write
    try:
        w = AsyncWriter()
        for i in range(5):
            hdr = Header()
            hdr["IDX"] = i
            w.submit(str(tmp_path / f"o{i}.fits"),
                     np.full((8, 8), float(i), np.float32), hdr)
        assert not os.listdir(tmp_path)      # nothing written yet
        gate.set()
        w.close()                            # returns once all are on disk
    finally:
        tpipe.write_image = real
    for i in range(5):
        data, hdr = read_image(str(tmp_path / f"o{i}.fits"))
        np.testing.assert_array_equal(data, float(i))
        assert hdr["IDX"] == i


@pytest.mark.parametrize("dtype", [torch.uint16, torch.float32])
def test_async_writer_takes_a_tensor(tmp_path, dtype):
    """``RawConv.grey(fetch=False)`` hands over a uint16 tensor; the
    worker brings it to the host."""
    values = np.arange(48).reshape(6, 8) * 1300
    tensor = torch.from_numpy(values.astype(np.int32)).to(torch.float32)
    if dtype == torch.uint16:
        tensor = torch.from_numpy(values.astype(np.uint16))
    path = str(tmp_path / "t.fits")
    with AsyncWriter() as w:
        w.submit(path, tensor)
    data, _ = read_image(path, as_float32=False)
    assert data.dtype == (np.uint16 if dtype == torch.uint16
                          else np.float32)
    np.testing.assert_array_equal(data, values)


def test_async_writer_error_surfaces_on_close(tmp_path):
    w = AsyncWriter()
    w.submit(str(tmp_path / "nodir" / "x.fits"), np.zeros((4, 4)))
    good = str(tmp_path / "good.fits")
    w.submit(good, np.ones((4, 4), np.float32))
    with pytest.raises(OSError):
        w.close()
    assert os.path.exists(good)              # later writes still happen
