"""2-NN descriptor matching (``openpano_tpu.match``'s public names)."""

from .matcher import MatchResult, match_adjacent_pairs, match_all_pairs, \
    match_pair

__all__ = ["MatchResult", "match_pair", "match_all_pairs",
           "match_adjacent_pairs"]
