"""ctypes bridge to the native C++ ingest fast path (native/ingest.cpp).

The reference's entire ingest is C++ (/root/reference/lib/utils.cpp:73-147,
lib/data_structures/tweet.cpp); our hot path matches that with a compiled
tokenizer+scorer whose output arrays are asserted identical to the Python
implementation (io/ingest.py) in tests.  The library is a build output (not
committed): it is built from native/ingest.cpp on first use with g++ -O3
and cached next to the source.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

from crypto_rec_tpu.io.ingest import TweetBatch

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = os.path.join(_REPO_ROOT, "native", "ingest.cpp")
_LIB = os.path.join(_REPO_ROOT, "native", "libcrt_ingest.so")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _build() -> None:
    # build beside the target and rename into place, so a concurrent
    # process never loads a half-written library
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    subprocess.run(
        ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", _SRC, "-o", tmp],
        check=True,
        capture_output=True,
    )
    os.replace(tmp, _LIB)


def load_library(rebuild: bool = False) -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None and not rebuild:
            return _lib
        if rebuild or not os.path.exists(_LIB) or (
            os.path.getmtime(_LIB) < os.path.getmtime(_SRC)
        ):
            _build()
        lib = ctypes.CDLL(_LIB)
        lib.crt_ingest_run.restype = ctypes.c_void_p
        lib.crt_ingest_run.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_char, ctypes.c_int,
        ]
        for fn in ("crt_n_tweets", "crt_n_users", "crt_n_pairs"):
            getattr(lib, fn).restype = ctypes.c_int64
            getattr(lib, fn).argtypes = [ctypes.c_void_p]
        lib.crt_n_coins.restype = ctypes.c_int32
        lib.crt_n_coins.argtypes = [ctypes.c_void_p]
        lib.crt_fill.restype = None
        lib.crt_fill.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 4
        for fn in ("crt_user_id", "crt_tweet_id"):
            getattr(lib, fn).restype = ctypes.c_char_p
            getattr(lib, fn).argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.crt_free.restype = None
        lib.crt_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


def native_available() -> bool:
    try:
        load_library()
        return True
    except (OSError, subprocess.CalledProcessError):
        return False


def score_tweets_native(
    tweets_path: str,
    lexicon_path: str,
    coins_path: str,
    delimiter: str,
    has_header: bool = True,
) -> TweetBatch:
    """File-level ingest: equivalent to read_str_vectors + score_tweets."""
    lib = load_library()
    h = lib.crt_ingest_run(
        tweets_path.encode(), lexicon_path.encode(), coins_path.encode(),
        delimiter.encode()[0:1], 1 if has_header else 0,
    )
    if not h:
        raise IOError(
            f"native ingest failed to open one of: {tweets_path}, "
            f"{lexicon_path}, {coins_path}"
        )
    try:
        n_t = lib.crt_n_tweets(h)
        n_u = lib.crt_n_users(h)
        n_p = lib.crt_n_pairs(h)
        tweet_user = np.empty(n_t, np.int32)
        scores = np.empty(n_t, np.float32)
        pair_tweet = np.empty(n_p, np.int32)
        pair_coin = np.empty(n_p, np.int32)
        lib.crt_fill(
            h,
            tweet_user.ctypes.data_as(ctypes.c_void_p),
            scores.ctypes.data_as(ctypes.c_void_p),
            pair_tweet.ctypes.data_as(ctypes.c_void_p),
            pair_coin.ctypes.data_as(ctypes.c_void_p),
        )
        user_ids = [lib.crt_user_id(h, i).decode() for i in range(n_u)]
        tweet_ids = [lib.crt_tweet_id(h, i).decode() for i in range(n_t)]
        return TweetBatch(
            user_ids=user_ids,
            tweet_ids=tweet_ids,
            tweet_user=tweet_user,
            scores=scores,
            pair_tweet=pair_tweet,
            pair_coin=pair_coin,
            n_coins=int(lib.crt_n_coins(h)),
        )
    finally:
        lib.crt_free(h)
