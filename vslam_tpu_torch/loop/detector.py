"""Loop-closure detection: inverted file, candidate scoring, consistency.

Host-side port of the reference's detection logic (device work — BoW
transform and descriptor matching — happens in jitted programs elsewhere):

- inverted file + shared-word counting  (loop_closure_utils.h:141-181,
  insert_new_kf_to_db :269-275);
- min-covisible-score gate              (:109-126);
- 0.8*max shared-word threshold, L1 scores, accumulated-score 0.75
  retention                             (:186-250);
- temporal consistency groups (3 consecutive)  (:294-388);
- relocalization candidates (top-5, 0.8*max shared words)
  (tracking.h:169-221).

Keyframes are identified by their slot index. The reference's
num_sharing_words initializes first occurrences to 0 (an off-by-one
keeping counts = occurrences - 1, loop_closure_utils.h:166-178); mirrored
here so thresholds behave identically.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

from . import vocabulary as vocab_mod


class BowDatabase:
    """Inverted file: word -> [kf_slot] (DBoWInvertedFile equivalent)."""

    def __init__(self):
        self.inverted: Dict[int, List[int]] = {}
        self.bow_of: Dict[int, dict] = {}   # slot -> {word: weight}

    def insert(self, slot: int, bow: dict) -> None:
        self.bow_of[slot] = bow
        for w in bow:
            self.inverted.setdefault(w, []).append(slot)

    def shared_word_counts(self, bow: dict,
                           exclude: Optional[Set[int]] = None,
                           reinclude: Optional[Set[int]] = None
                           ) -> Dict[int, int]:
        """occurrences-1 counts per KF sharing words (reference quirk)."""
        counts: Dict[int, int] = {}
        for w in bow:
            for slot in self.inverted.get(w, ()):  # noqa: B905
                if exclude and slot in exclude and not (
                        reinclude and slot in reinclude):
                    continue
                counts[slot] = counts[slot] + 1 if slot in counts else 0
        return counts


class LoopDetector:
    """Consistency-group loop detection (detect_loop_closure)."""

    def __init__(self, num_consistency: int = 3):
        self.db = BowDatabase()
        self.consistent_groups: List[Tuple[Set[int], int]] = []
        self.num_consistency = num_consistency

    # -- scoring helpers ---------------------------------------------------
    def min_connected_covisible(self, new_bow: dict,
                                covis_weights: Dict[int, int],
                                threshold: int) -> float:
        """compute_min_connected_covisible (loop_closure_utils.h:109-126)."""
        min_score = 1.0
        for slot, w in covis_weights.items():
            if w > threshold and slot in self.db.bow_of:
                s = vocab_mod.l1_score(new_bow, self.db.bow_of[slot])
                min_score = min(min_score, s)
        return min_score

    def detect_candidates(self, new_slot: int, new_bow: dict,
                          covis_weights: Dict[int, int],
                          graph: Dict[int, Set[int]],
                          min_score: float,
                          essential_threshold: int = 30) -> List[int]:
        """detect_loop_candidates (loop_closure_utils.h:141-263).

        ``essential_threshold``: covisible keyframes below this weight
        re-enter the shared-word counting (the reference hardcodes its
        essential-edge default, 30, at loop_closure_utils.h:172).
        """
        connected = set(graph.get(new_slot, ()))
        reinclude = {s for s in connected
                     if covis_weights.get(s, 0) < essential_threshold}
        counts = self.db.shared_word_counts(new_bow, exclude=connected,
                                            reinclude=reinclude)
        if not counts:
            return []
        max_count = max(counts.values())
        thresh = int(max_count * 0.8)
        scores: Dict[int, float] = {}
        scored: List[Tuple[float, int]] = []
        for slot, c in counts.items():
            if c > thresh:
                s = vocab_mod.l1_score(new_bow, self.db.bow_of[slot])
                scores[slot] = s
                if s >= min_score:
                    scored.append((s, slot))
        if not scored:
            return []

        best_acc = min_score
        for s, slot in scored:
            acc = s
            for nbr in graph.get(slot, ()):  # accumulate over covis group
                if counts.get(nbr, -1) > thresh and nbr in scores:
                    acc += scores[nbr]
            best_acc = max(best_acc, acc)

        retain = 0.75 * best_acc
        seen: Set[int] = set()
        out = []
        for s, slot in scored:
            if s > retain and slot not in seen:
                out.append(slot)
                seen.add(slot)
        return out

    # -- main entry ---------------------------------------------------------
    def detect(self, new_slot: int, new_bow: dict,
               covis_weights: Dict[int, int],
               graph: Dict[int, Set[int]],
               covis_threshold: int,
               essential_threshold: int = 30) -> List[int]:
        """Returns consistent loop candidates; also inserts new_slot in db."""
        min_score = self.min_connected_covisible(
            new_bow, covis_weights, covis_threshold)
        candidates = self.detect_candidates(
            new_slot, new_bow, covis_weights, graph, min_score,
            essential_threshold)

        if not candidates:
            self.consistent_groups = []
            self.db.insert(new_slot, new_bow)
            return []

        enough: List[int] = []
        current_groups: List[Tuple[Set[int], int]] = []
        old_used = [False] * len(self.consistent_groups)
        for cand in candidates:
            group = set(graph.get(cand, ())) | {cand}
            consistent_somewhere = False
            accepted = False
            for gi, (prev_group, n) in enumerate(self.consistent_groups):
                if group & prev_group:
                    consistent_somewhere = True
                    n_curr = n + 1
                    if not old_used[gi]:
                        current_groups.append((group, n_curr))
                        old_used[gi] = True
                    if n_curr >= self.num_consistency and not accepted:
                        enough.append(cand)
                        accepted = True
            if not consistent_somewhere:
                current_groups.append((group, 0))
        self.consistent_groups = current_groups
        self.db.insert(new_slot, new_bow)
        return enough

    # -- relocalization -----------------------------------------------------
    def relocalization_candidates(self, bow: dict, max_out: int = 5
                                  ) -> List[int]:
        """detect_relocalization_candidate (tracking.h:169-221)."""
        counts = self.db.shared_word_counts(bow)
        if not counts:
            return []
        max_count = max(counts.values())
        thresh = int(max_count * 0.8)
        scored = []
        for slot, c in counts.items():
            if c > thresh:
                scored.append((vocab_mod.l1_score(bow, self.db.bow_of[slot]),
                               slot))
        scored.sort(key=lambda x: -x[0])
        return [slot for _, slot in scored[:max_out]]
