"""The comparison that decides ``correct``: the window's outputs against
the reference's, on the same frames.

- ``base_lsb``: the largest difference of a baseline, in uint8 steps;
- ``out_lsb``: the largest difference of a transformed frame;
- ``out_off_pct``: the share of a species' transformed bytes that differ
  at all, in %, for the species where it is largest;
- ``out_psnr_db``: a species' transformed frames' PSNR against the
  reference (the mean squared error floored at 1e-10, so 148 dB means
  equal), for the species where it is lowest.

The two numbers of shares are taken per species so that they read the
same whatever share of the sample one species has.

Each number's limit and direction come from the configuration's file.
"""

from __future__ import annotations

import math

import torch


def nearest_rank(values, q: float) -> float:
    """The q-th percentile by nearest rank: the value at rank ceil(q/100 n)."""
    s = sorted(values)
    return s[max(0, math.ceil(q / 100.0 * len(s)) - 1)]


class Accumulator:
    def __init__(self):
        self.base_lsb = None
        self.out_lsb = 0
        self.species: dict[str, list] = {}  # species -> [bytes off, squared error, bytes]

    def add(self, species: str, base, ref_base, out, ref_out) -> None:
        if base is not None:
            d = int((base.to(torch.int16) - ref_base.to(torch.int16)).abs().max())
            self.base_lsb = d if self.base_lsb is None else max(self.base_lsb, d)
        diff = out.to(torch.int16) - ref_out.to(torch.int16)
        self.out_lsb = max(self.out_lsb, int(diff.abs().max()))
        acc = self.species.setdefault(species, [0, 0.0, 0])
        acc[0] += int((diff != 0).sum())
        acc[1] += float((diff.to(torch.float64) ** 2).sum())
        acc[2] += diff.numel()

    def numbers(self) -> dict:
        out = {}
        if self.base_lsb is not None:
            out["base_lsb"] = self.base_lsb
        if self.species:
            out["out_lsb"] = self.out_lsb
            out["out_off_pct"] = max(100.0 * off / n for off, _, n in self.species.values())
            out["out_psnr_db"] = min(10.0 * math.log10(255.0**2 / max(sq / n, 1e-10))
                                     for _, sq, n in self.species.values())
        return out

    def judge(self, spec: dict) -> dict:
        """``{name: {"value", "limit", "ok"}}`` for each number the spec
        names. A number that the run could not read fails, but for
        ``base_lsb`` in a mix that emits no baselines."""
        got = self.numbers()
        res = {}
        for name, s in spec.items():
            if name not in got:
                if name == "base_lsb" and "out_lsb" in got:
                    continue  # the mix emits no baselines (``split`` off)
                res[name] = {"value": None, "limit": s["limit"], "ok": False}
                continue
            v = got[name]
            ok = v <= s["limit"] if s["better"] == "lower" else v >= s["limit"]
            res[name] = {"value": v, "limit": s["limit"], "ok": bool(ok)}
        return res
