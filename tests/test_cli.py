"""End-to-end CLI test: PNG in -> disparity PNG out (main.cc surface)."""

import numpy as np

from crossscalepatchmatch import io as cspm_io
from crossscalepatchmatch.cli import main
from crossscalepatchmatch.data import make_pair
from crossscalepatchmatch.metrics import bad_pixel_rate


def test_cli_roundtrip(tmp_path):
    pair = make_pair(h=64, w=96, max_dis=12, seed=3)
    lp, rp = tmp_path / "l.png", tmp_path / "r.png"
    lo, ro = tmp_path / "ld.png", tmp_path / "rd.png"
    cspm_io.write_bgr(str(lp), pair.left)
    cspm_io.write_bgr(str(rp), pair.right)

    rc = main(["--l_img_file", str(lp), "--r_img_file", str(rp),
               "--l_dis_file", str(lo), "--r_dis_file", str(ro),
               "--max_dis", "12", "--dis_scale", "16", "--cc_name", "GRD",
               "--use_cs", "false", "--use_pp", "true",
               "--wnd_size", "15", "--reg_lambda", "0.0"])
    assert rc == 0
    dis = cspm_io.read_gray(str(lo))
    assert dis.shape == (64, 96)
    bad = bad_pixel_rate(dis.astype(np.float32) / 16.0, pair.disp_left,
                         pair.valid_left)
    assert bad < 0.15, bad


def test_cli_photo_textured_pair(tmp_path):
    """CLI smoke test on a REAL-photograph-textured pair (the closest an
    egress-less host gets to the reference's Middlebury smoke runs):
    grace_hopper.jpg crops as layer textures over exact GT geometry."""
    import pytest

    from crossscalepatchmatch.data import load_host_photo, photo_textures

    photo = load_host_photo()
    if photo is None:
        pytest.skip("no host photo available")
    h, w, md = 64, 96, 12
    texs = photo_textures(photo, 4, h, w + md + 4,
                          np.random.default_rng(5))
    pair = make_pair(h=h, w=w, max_dis=md, seed=3, textures=texs)
    lp, rp = tmp_path / "l.png", tmp_path / "r.png"
    lo, ro = tmp_path / "ld.png", tmp_path / "rd.png"
    cspm_io.write_bgr(str(lp), pair.left)
    cspm_io.write_bgr(str(rp), pair.right)
    rc = main(["--l_img_file", str(lp), "--r_img_file", str(rp),
               "--l_dis_file", str(lo), "--r_dis_file", str(ro),
               "--max_dis", "12", "--dis_scale", "16", "--cc_name", "CEN",
               "--use_cs", "false", "--use_pp", "true",
               "--wnd_size", "15", "--reg_lambda", "0.0"])
    assert rc == 0
    dis = cspm_io.read_gray(str(lo))
    bad = bad_pixel_rate(dis.astype(np.float32) / 16.0, pair.disp_left,
                         pair.valid_left)
    assert bad < 0.15, bad


def test_cli_input_list(tmp_path):
    """Batch mode: a reference-style input.txt of flag lines runs every
    line in one process (CSPM/input.txt:1-20 format, incl. quoted values
    and a leading binary token)."""
    pair = make_pair(h=48, w=64, max_dis=8, seed=2)
    lp, rp = tmp_path / "l.png", tmp_path / "r.png"
    cspm_io.write_bgr(str(lp), pair.left)
    cspm_io.write_bgr(str(rp), pair.right)
    lst = tmp_path / "input.txt"
    lst.write_text(
        f'--l_img_file="{lp}" --r_img_file="{rp}" '
        f'--l_dis_file="{tmp_path}/a_l.png" --r_dis_file="{tmp_path}/a_r.png" '
        f'--max_dis=8 --dis_scale=16 --cc_name="GRD" --use_cs=false '
        f'--use_pp=false --wnd_size=11\n'
        f'\n'
        f'CSPM.exe --l_img_file={lp} --r_img_file={rp} '
        f'--l_dis_file={tmp_path}/b_l.png --r_dis_file={tmp_path}/b_r.png '
        f'--max_dis=8 --dis_scale=16 --cc_name=GRD --use_cs=false '
        f'--use_pp=false --wnd_size=11 --seed=1\n')
    rc = main(["--input_list", str(lst)])
    assert rc == 0
    a = cspm_io.read_gray(str(tmp_path / "a_l.png"))
    b = cspm_io.read_gray(str(tmp_path / "b_l.png"))
    assert a.shape == b.shape == (48, 64)
    # different seeds -> (almost surely) different maps, same scene
    bad_a = bad_pixel_rate(a.astype(np.float32) / 16.0, pair.disp_left,
                           pair.valid_left)
    bad_b = bad_pixel_rate(b.astype(np.float32) / 16.0, pair.disp_left,
                           pair.valid_left)
    assert bad_a < 0.2 and bad_b < 0.2, (bad_a, bad_b)


def test_cli_shape_mismatch(tmp_path):
    pair = make_pair(h=32, w=48, max_dis=8, seed=1)
    lp, rp = tmp_path / "l.png", tmp_path / "r.png"
    cspm_io.write_bgr(str(lp), pair.left)
    cspm_io.write_bgr(str(rp), pair.right[:16])
    rc = main(["--l_img_file", str(lp), "--r_img_file", str(rp),
               "--l_dis_file", "x.png", "--r_dis_file", "y.png"])
    assert rc == 1
