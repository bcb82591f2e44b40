"""The share of the member-steps the untraced window's lock-step retrains
computed that belonged to members still training, in %: the rest
(``fit_masked_member_steps`` of ``fit_member_steps``) the step computes for
members already stopped by early stopping and masks out of the update.
It reads 100 where no member stopped before the others."""

from benchmarks.harness.spans import window_fits


def read(ctx):
    fits = window_fits(ctx)
    if not fits or any("fit_member_steps" not in f for f in fits):
        return None
    total = sum(f["fit_member_steps"] for f in fits)
    masked = sum(f["fit_masked_member_steps"] for f in fits)
    return 100.0 * (total - masked) / total if total else None
