"""The port's host numpy copies == the JAX package's: HDR response recovery
and merge, the RGBE and EXR formats (each package reads the other's
files), the Octave dump, the four demosaicers, the PMVS export and the
file-backed capture.  All of them are bit-equal: the same numpy code on
the same inputs."""

import io
import os

import numpy as np
import pytest
from PIL import Image

from stereoreconstruction_tpu.data import demosaic as jdm
from stereoreconstruction_tpu.data import formats as jfmt
from stereoreconstruction_tpu.data import pmvs as jpmvs
from stereoreconstruction_tpu.hdr import merge as jmerge
from stereoreconstruction_tpu.hdr import response as jresp
from stereoreconstruction_tpu.runtime import capture as jcap
from stereoreconstruction_tpu_torch.data import demosaic as tdm
from stereoreconstruction_tpu_torch.data import formats as tfmt
from stereoreconstruction_tpu_torch.data import pmvs as tpmvs
from stereoreconstruction_tpu_torch.hdr import merge as tmerge
from stereoreconstruction_tpu_torch.hdr import response as tresp
from stereoreconstruction_tpu_torch.runtime import capture as tcap

from test_hdr import synth_stack


def test_response_and_merge_equal_jax():
    """recover_response with the same generator seed, then merge_hdr:
    bit-equal curves and radiance, and the radiance within
    tests/test_hdr.py's tolerance of the truth."""
    images, exps, radiance, _ = synth_stack(np.random.default_rng(0))
    want = jresp.recover_response(images, exps,
                                  rng=np.random.default_rng(5))
    got = tresp.recover_response(images, exps, rng=np.random.default_rng(5))
    np.testing.assert_array_equal(got, want)
    hdr = tmerge.merge_hdr(images, exps, got)
    np.testing.assert_array_equal(hdr, jmerge.merge_hdr(images, exps, want))
    mask = (radiance > 0.1) & (radiance < 3.0)
    scale = np.median(hdr[mask] / radiance[mask])
    rel = np.abs(hdr[mask] / scale - radiance[mask]) / radiance[mask]
    assert np.median(rel) < 0.1
    v = np.arange(256)
    np.testing.assert_array_equal(tmerge.pixel_weight(v),
                                  jmerge.pixel_weight(v))


def test_formats_round_trip_across_packages(tmp_path):
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 8, (16, 20, 3))
    img[0, 0] = 0
    np.testing.assert_array_equal(tfmt.float_to_rgbe(img),
                                  jfmt.float_to_rgbe(img))
    for writer, reader in ((tfmt.write_rgbe, jfmt.read_rgbe),
                           (jfmt.write_rgbe, tfmt.read_rgbe)):
        p = str(tmp_path / "t.hdr")
        writer(p, img)
        back = reader(p)
        np.testing.assert_array_equal(back, jfmt.rgbe_to_float(
            jfmt.float_to_rgbe(img)))
        assert np.median(np.abs(back - img)[img > 0.01]) < 0.05
    f32 = img.astype(np.float32)
    for half, rtol in ((False, 1e-6), (True, 2e-3)):
        for writer, reader in ((tfmt.write_exr, jfmt.read_exr),
                               (jfmt.write_exr, tfmt.read_exr)):
            p = tmp_path / f"t{int(half)}.exr"
            writer(str(p), f32, half=half)
            back = reader(str(p))
            np.testing.assert_allclose(back, f32, rtol=rtol, atol=1e-7)
        tfmt.write_exr(str(tmp_path / "a.exr"), f32, half=half)
        jfmt.write_exr(str(tmp_path / "b.exr"), f32, half=half)
        assert (tmp_path / "a.exr").read_bytes() == (
            tmp_path / "b.exr").read_bytes()
    m = np.array([[1.5, -2.0, 3.25], [0.0, 4.0, 5.5]])
    bufs = [io.StringIO(), io.StringIO()]
    tfmt.write_octave_matrix(bufs[0], "P", m)
    jfmt.write_octave_matrix(bufs[1], "P", m)
    assert bufs[0].getvalue() == bufs[1].getvalue()


@pytest.mark.parametrize("name", ["es", "nn", "bl", "hue"])
def test_demosaicers_equal_jax(name):
    rng = np.random.default_rng(3)
    for h, w in ((24, 32), (17, 23)):
        raw = rng.integers(0, 256, (h, w), dtype=np.uint8)
        got = tdm.DEMOSAICERS[name](raw)
        assert got.dtype == np.uint8 and got.shape == (h, w, 3)
        np.testing.assert_array_equal(got, jdm.DEMOSAICERS[name](raw))


def test_pmvs_export_and_capture_equal_jax(tmp_path):
    rng = np.random.default_rng(4)
    img = tmp_path / "a.png"
    Image.fromarray(rng.integers(0, 255, (8, 10, 3)).astype(np.uint8)).save(
        img)
    Ps = [np.hstack([np.eye(3), np.zeros((3, 1))]),
          rng.normal(size=(3, 4)) * 100]
    outs = {}
    for name, mod in (("port", tpmvs), ("jax", jpmvs)):
        out = tmp_path / name
        argv = mod.export_pmvs(str(out), Ps, [str(img), str(img)])
        assert argv == ["pmvs-2", str(out) + os.sep, "option.txt"]
        outs[name] = {str(p.relative_to(out)): p.read_bytes()
                      for p in out.rglob("*") if p.is_file()}
    assert outs["port"] == outs["jax"]
    assert outs["port"]["txt/00000000.txt"].startswith(b"CONTOUR")
    assert b"timages -1 0 2" in outs["port"]["option.txt"]

    # capture: per-camera directories of raw mosaics (.npy and .pgm)
    dirs = [tmp_path / "cam0", tmp_path / "cam1"]
    for k, d in enumerate(dirs):
        d.mkdir()
        for f in range(2):
            raw = rng.integers(0, 256, (12, 16), dtype=np.uint8)
            if k == 0:
                np.save(d / f"f{f}.npy", raw)
            else:
                Image.fromarray(raw, "L").save(d / f"f{f}.pgm")
    tc = tcap.FileCaptureBackend([str(d) for d in dirs], demosaic="hue")
    jc = jcap.FileCaptureBackend([str(d) for d in dirs], demosaic="hue")
    assert tc.num_cameras() == 2
    for _ in range(2):
        for a, b in zip(tc.capture(), jc.capture()):
            assert a.camera_index == b.camera_index
            np.testing.assert_array_equal(a.rgb, b.rgb)
    with pytest.raises(StopIteration):
        tc.capture()
