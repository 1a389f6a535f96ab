"""Chart signal widths, copied from osu_dreamer_tpu/signal/encoding.py (that
module imports jaxtyping; tests/test_torch_modules.py pins each value to the
original): 7 hit channels + 2 cursor channels, 5 difficulty labels
(sr, ar, od, cs, hp)."""

HIT_DIM = 7
CURSOR_DIM = 2
X_DIM = HIT_DIM + CURSOR_DIM
NUM_LABELS = 5
