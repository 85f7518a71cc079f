"""Slow, direct NumPy oracle of the reference semantics for golden tests.

Written as literal nested loops mirroring the *behavior* documented in
SURVEY.md (not the reference's code structure) so the dense engine ops can be
checked element-by-element on tiny inputs.
"""

from __future__ import annotations

import numpy as np


def gray_f32(rgb):
    rgb = rgb.astype(np.float64)
    return 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]


def gray_u8(rgb_u8):
    r = rgb_u8[..., 0].astype(np.int64)
    g = rgb_u8[..., 1].astype(np.int64)
    b = rgb_u8[..., 2].astype(np.int64)
    return ((r * 4899 + g * 9617 + b * 1868 + (1 << 13)) >> 14).astype(np.uint8)


def sobel_x_k1(gray):
    h, w = gray.shape
    out = np.zeros((h, w), np.float64)
    for y in range(h):
        for x in range(1, w - 1):
            out[y, x] = gray[y, x + 1] - gray[y, x - 1]
    return out


def grd_volume(l_rgb, r_rgb, max_dis, alpha=0.1, tau_clr=10.0, tau_grd=2.0,
               border=3.0, right=False):
    h, w, _ = l_rgb.shape
    lg = sobel_x_k1(gray_f32(l_rgb))
    rg = sobel_x_k1(gray_f32(r_rgb))
    vol = np.zeros((h, w, max_dis + 1), np.float64)
    for d in range(max_dis + 1):
        for y in range(h):
            for x in range(w):
                if right:
                    ok = x + d < w
                    a, b = (r_rgb[y, x], l_rgb[y, x + d]) if ok else (r_rgb[y, x], None)
                    ga, gb = (rg[y, x], lg[y, x + d]) if ok else (rg[y, x], None)
                else:
                    ok = x - d >= 0
                    a, b = (l_rgb[y, x], r_rgb[y, x - d]) if ok else (l_rgb[y, x], None)
                    ga, gb = (lg[y, x], rg[y, x - d]) if ok else (lg[y, x], None)
                if ok:
                    clr = np.mean(np.abs(a.astype(np.float64) - b.astype(np.float64)))
                    grd = abs(ga - gb)
                else:
                    clr = np.mean(np.abs(a.astype(np.float64) - border))
                    grd = abs(ga - border)
                vol[y, x, d] = (alpha * min(clr, tau_clr)
                                + (1 - alpha) * min(grd, tau_grd))
    return vol


def census_codes(gray, wnd=9):
    h, w = gray.shape
    half = wnd // 2
    bits = wnd * wnd - 1
    codes = np.zeros((h, w, bits), bool)
    for y in range(h):
        for x in range(w):
            i = 0
            for wy in range(-half, half + 1):
                qy = (y + wy + h) % h
                for wx in range(-half, half + 1):
                    if wy == 0 and wx == 0:
                        continue
                    qx = (x + wx + w) % w
                    codes[y, x, i] = gray[y, x] > gray[qy, qx]
                    i += 1
    return codes


def census_volume(l_gray, r_gray, max_dis, wnd=9, right=False):
    h, w = l_gray.shape
    bits = wnd * wnd - 1
    lc = census_codes(l_gray, wnd)
    rc = census_codes(r_gray, wnd)
    vol = np.full((h, w, max_dis + 1), float(bits), np.float64)
    for d in range(max_dis + 1):
        for y in range(h):
            for x in range(w):
                if right:
                    if x + d < w:
                        vol[y, x, d] = np.sum(rc[y, x] ^ lc[y, x + d])
                else:
                    if x - d >= 0:
                        vol[y, x, d] = np.sum(lc[y, x] ^ rc[y, x - d])
    return vol


def plane_cost_ss(img_u8, vol, max_cost, abc, half_wnd, max_dis, gamma=10.0):
    """Single-scale windowed plane cost for one plane field [H, W, 3]."""
    h, w, _ = img_u8.shape
    out = np.zeros((h, w), np.float64)
    img = img_u8.astype(np.int64)
    for y in range(h):
        for x in range(w):
            a, b, c = abc[y, x]
            cost = 0.0
            for dy in range(-half_wnd, half_wnd + 1):
                qy = y + dy
                if not (0 <= qy < h):
                    continue
                for dx in range(-half_wnd, half_wnd + 1):
                    qx = x + dx
                    if not (0 <= qx < w):
                        continue
                    l1 = np.sum(np.abs(img[y, x] - img[qy, qx]))
                    wgt = np.exp(-l1 / gamma)
                    dq = a * qx + b * qy + c
                    f = int(dq)  # C trunc
                    if f <= 0 or f >= max_dis:
                        cost += wgt * max_cost
                    else:
                        fw = (f + 1) - dq
                        cost += wgt * (fw * vol[qy, qx, f]
                                       + (1 - fw) * vol[qy, qx, f + 1])
            out[y, x] = cost
    return out


def plane_cost_cs(imgs, vols, max_costs, wgts, abc, half_wnd, max_dis,
                  gamma=10.0):
    """Cross-scale plane cost for one plane field at full resolution."""
    h, w, _ = imgs[0].shape
    out = np.zeros((h, w), np.float64)
    for y in range(h):
        for x in range(w):
            a, b, c = abc[y, x]
            disp = a * x + b * y + c
            cx, cy, cd = x, y, disp
            total = 0.0
            md = max_dis
            for s in range(len(imgs)):
                img = imgs[s].astype(np.int64)
                hs, ws, _ = imgs[s].shape
                cs = cd - a * cx - b * cy
                sc = 0.0
                for dy in range(-half_wnd, half_wnd + 1):
                    qy = cy + dy
                    if not (0 <= qy < hs):
                        continue
                    for dx in range(-half_wnd, half_wnd + 1):
                        qx = cx + dx
                        if not (0 <= qx < ws):
                            continue
                        l1 = np.sum(np.abs(img[cy, cx] - img[qy, qx]))
                        wgt = np.exp(-l1 / gamma)
                        dq = a * qx + b * qy + cs
                        f = int(dq)
                        if f <= 0 or f >= md:
                            sc += wgt * max_costs[s]
                        else:
                            fw = (f + 1) - dq
                            sc += wgt * (fw * vols[s][qy, qx, f]
                                         + (1 - fw) * vols[s][qy, qx, f + 1])
                total += wgts[s] * sc
                cx //= 2
                cy //= 2
                cd /= 2.0
                md //= 2
            out[y, x] = total
    return out
