"""Pallas kernels, each beside the plain XLA form that is its reference
and its CPU path (see slabscore.window_dots_impl)."""

from crypto_rec_tpu.ops.pallas.slabscore import packed_retrieve_pallas  # noqa: F401
