"""Batch-local feature tables for the train path (counterpart of
lirec_tpu/data/localize.Localizer).

A batch references only a few thousand of the tables' rows. Localizing it
remaps ``feat_idx`` to the batch's unique rows (``uniq_clip``,
``uniq_track``), so the table-level first layers, their backward and the
scatter-accumulate kernel run at batch-unique size. The analysis, the
capacities and the profitability gate are lirec_tpu's own; only the
record of the decision goes to the port's dispatch (lirec_tpu's imports
jax).
"""

from __future__ import annotations

from typing import Dict, List

from lirec_tpu.data import localize as _jax_free

from lirec_tpu_torch.ops import dispatch

__all__ = ["Localizer"]


class Localizer(_jax_free.Localizer):
    """Capacities measured from the data, grown monotonically, and the
    profitability gate applied once per growth against the tables."""

    def maybe_localize(self, batches: List[Dict]) -> List[Dict]:
        """Localize an epoch's batches (all at the current capacities), or
        return them unchanged when disabled or unprofitable."""
        if not self.enabled or not batches or "feat_idx" not in batches[0]:
            return batches
        infos = [_jax_free._analyze(b, self.n_clips, self.n_tracks)
                 for b in batches]
        mc = max(uc.size for uc, _, _ in infos)
        mt = max(ut.size for _, ut, _ in infos)
        self.cap_clip = max(self.cap_clip,
                            _jax_free._round_up(mc, self.n_clips))
        self.cap_track = max(self.cap_track,
                             _jax_free._round_up(mt, self.n_tracks))
        shapes = {"caps": (self.cap_clip, self.cap_track),
                  "tables": (self.n_clips, self.n_tracks)}
        if not self._profitable():
            if self.force is not True:
                self.enabled = False  # cardinality won't shrink
            dispatch.record(
                "localize_tables", "off",
                "batch-unique rows not under %.0f%% of table rows"
                % (100 * _jax_free._PROFIT_FRAC), shapes)
            return batches
        out = [_jax_free._emit(b, nfi, uc, ut, self.cap_clip, self.cap_track)
               for b, (uc, ut, nfi) in zip(batches, infos)]
        self.applied = True
        dispatch.record("localize_tables", "on",
                        "forced" if self.force is True else "profitable",
                        shapes)
        return out
