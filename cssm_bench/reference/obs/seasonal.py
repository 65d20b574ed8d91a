"""Seasonal component: its states load on ``cos`` and ``sin`` of
``2 pi a t / period`` for the harmonics ``a = 1..h``, interleaved
(SeasonalModel.buildF, Model.scala:217-225).  Only its design is defined
here: in the configurations it never stands leftmost, so its observation
family is never used."""

from __future__ import annotations

DESIGN = "fourier"
