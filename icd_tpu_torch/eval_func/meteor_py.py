"""Pure-Python METEOR 1.5 (exact + stem matchers) — jar-free fallback.

The reference scores METEOR through ``meteor-1.5.jar`` (reference:
eval_func/meteor/meteor.py:18-24), a large external artifact missing
from the reference snapshot itself (.MISSING_LARGE_BLOBS) and from this
container (no Java runtime either). This module reimplements the
Meteor 1.5 scoring algorithm (Denkowski & Lavie 2014, "Meteor
Universal"; formulas from the Meteor 1.3 paper) in pure Python so
jar-less deployments can produce real METEOR numbers instead of 0.0.

Faithfulness:

- **On the reference's actual eval input this is the full metric.**
  The eval protocol joins token *ids* into space-separated digit
  strings before scoring (reference: metric.py:7-27; icd_tpu/metric.py
  preserves the quirk). On digit "words" the jar's stem, synonym and
  paraphrase stages can never produce a match that exact doesn't
  (digits stem to themselves; WordNet/paraphrase tables contain no
  digit strings), and the English function-word list contains no digit
  strings either, so the content/function weight ``delta`` cancels.
  METEOR 1.5 on id strings therefore reduces *exactly* to the
  exact-matcher computation implemented here. Sanity calibration: with
  these parameters, corpus P~=Bleu_1=0.493 of the reference's published
  baseline_3.json predicts METEOR ~0.225 vs its jar-produced 0.2254.
- **On surface words it is a documented approximation**: exact + stem
  modules only (stem via NLTK's Snowball English stemmer, the same
  algorithm the jar uses, weight 0.6); the synonym (WordNet, 0.8) and
  paraphrase (phrase table, 0.6) stages are omitted because their data
  files are exactly the kind of large blob the jar itself is. The
  function-word list is a built-in approximation of the jar's
  ``function.words`` resource.
- The alignment is a beam search (width 64) over hypothesis positions
  with Meteor's published resolution order — most covered words, then
  fewest chunks, then smallest sum of absolute position distances —
  verified exhaustively optimal on small inputs by tests
  (tests/test_meteor_py.py).

Parameters are Meteor 1.5's English ranking-task defaults:
alpha=0.85, beta=0.2, gamma=0.6, delta=0.75; module weights
exact=1.0, stem=0.6. Segment score = Fmean * (1 - gamma*frag**beta)
with Fmean = P*R/(alpha*P + (1-alpha)*R) and frag = chunks/matches.
Corpus score aggregates summed sufficient statistics (as the jar's
-stdio EVAL does), not a mean of segment scores. Note hyp == ref does
NOT score 1.0 under these tuned parameters (a single full-cover chunk
still pays gamma*(1/m)**beta); that matches the jar.

Enable as the in-process fallback with ``ICD_TPU_METEOR_PY=1``
(icd_tpu/eval_func/meteor.py), or over the jar's stdio protocol with
``tools/meteor_stdio.py``.

A copy of ``icd_tpu/eval_func/meteor_py.py``: the port imports
nothing of ``icd_tpu``.
"""

ALPHA = 0.85
BETA = 0.2
GAMMA = 0.6
DELTA = 0.75
WEIGHT_EXACT = 1.0
WEIGHT_STEM = 0.6
BEAM = 64

# Approximation of the jar's en function.words resource (words whose
# relative frequency in a large English corpus exceeds 1e-3 — i.e.
# closed-class words). On the id-string eval path this list is
# irrelevant: no digit string is in it, so every token is content.
FUNCTION_WORDS = frozenset("""
a an the this that these those some any each every no all both either
neither i you he she it we they me him her us them my your his its our
their mine yours hers ours theirs myself yourself himself herself
itself ourselves yourselves themselves who whom whose which what when
where why how and or but nor so yet for if because although though
while unless until since as than whether of in on at by with from to
into onto over under above below between among through during before
after against about around near off out up down is am are was were be
been being have has had having do does did doing will would shall
should can could may might must not n't there here then now just also
too very s t d ll m re ve
""".split())


def _stem(token):
    """Snowball English stem (the jar's stemmer algorithm), lazily via
    NLTK; identity when NLTK is unavailable (stem module then never
    adds matches beyond exact). Memoized — stemming is a pure function
    of the token, and at corpus scale (202,654 eval samples) the
    unmemoized Snowball calls were ~38% of scorer time (profiled)."""
    global _STEMMER
    cached = _STEM_CACHE.get(token)
    if cached is not None:
        return cached
    if _STEMMER is None:
        try:
            from nltk.stem.snowball import SnowballStemmer

            _STEMMER = SnowballStemmer("english").stem
        except Exception:  # pragma: no cover - nltk is in the image
            _STEMMER = lambda w: w  # noqa: E731
    stemmed = _STEMMER(token)
    if len(_STEM_CACHE) >= 1_000_000:  # bound host memory
        _STEM_CACHE.clear()
    _STEM_CACHE[token] = stemmed
    return stemmed


_STEMMER = None
_STEM_CACHE = {}


def _match_candidates(hyp, ref, use_stem):
    """Per hypothesis position, the list of (ref position, module
    weight) candidate matches. A pair matching on both modules is
    credited to exact (the higher-priority module), as in the jar."""
    ref_index = {}
    for j, w in enumerate(ref):
        ref_index.setdefault(w, []).append(j)
    stem_index = {}
    hyp_stems = None
    if use_stem:
        for j, w in enumerate(ref):
            stem_index.setdefault(_stem(w), []).append(j)
        hyp_stems = [_stem(w) for w in hyp]
    cands = []
    for i, w in enumerate(hyp):
        exact = ref_index.get(w, ())
        pairs = [(j, WEIGHT_EXACT) for j in exact]
        if use_stem:
            taken = set(exact)
            pairs += [(j, WEIGHT_STEM)
                      for j in stem_index.get(hyp_stems[i], ())
                      if j not in taken]
        cands.append(pairs)
    return cands


class _State(object):
    __slots__ = ("used", "matches", "chunks", "dist",
                 "last_i", "last_j", "pairs")

    def __init__(self, used, matches, chunks, dist, last_i, last_j,
                 pairs):
        self.used = used          # bitmask of consumed ref positions
        self.matches = matches
        self.chunks = chunks
        self.dist = dist          # sum |i - j| over matches
        self.last_i = last_i      # last matched hyp position
        self.last_j = last_j      # ... and its ref position
        self.pairs = pairs        # tuple of (i, j, weight)

    def key(self):
        return (-self.matches, self.chunks, self.dist)


def align(hyp, ref, use_stem=False):
    """One-to-one word alignment, Meteor resolution order.

    Returns (pairs, chunks) with pairs a tuple of
    (hyp_pos, ref_pos, module_weight) sorted by hyp_pos.
    """
    cands = _match_candidates(hyp, ref, use_stem)
    states = [_State(0, 0, 0, 0, -2, -2, ())]
    for i, pairs in enumerate(cands):
        nxt = {}

        def push(s):
            k = (s.used, s.last_i, s.last_j)
            old = nxt.get(k)
            if old is None or s.key() < old.key():
                nxt[k] = s

        for s in states:
            push(_State(s.used, s.matches, s.chunks, s.dist,
                        s.last_i, s.last_j, s.pairs))  # skip hyp[i]
            for j, w in pairs:
                bit = 1 << j
                if s.used & bit:
                    continue
                contiguous = (s.last_i == i - 1 and s.last_j == j - 1)
                push(_State(s.used | bit, s.matches + 1,
                            s.chunks + (0 if contiguous else 1),
                            s.dist + abs(i - j), i, j,
                            s.pairs + ((i, j, w),)))
        states = sorted(nxt.values(), key=_State.key)[:BEAM]
    best = states[0]
    return best.pairs, best.chunks


class SegmentStats(object):
    """Sufficient statistics of one aligned (hyp, ref) pair — exactly
    what Meteor's -stdio SCORE emits and EVAL sums before applying the
    final formula once to the aggregate."""

    FIELDS = ("wm_hyp", "wm_ref", "wlen_hyp", "wlen_ref",
              "matches_hyp", "matches_ref", "chunks")

    def __init__(self, wm_hyp=0.0, wm_ref=0.0, wlen_hyp=0.0,
                 wlen_ref=0.0, matches_hyp=0.0, matches_ref=0.0,
                 chunks=0.0):
        self.wm_hyp = wm_hyp
        self.wm_ref = wm_ref
        self.wlen_hyp = wlen_hyp
        self.wlen_ref = wlen_ref
        self.matches_hyp = matches_hyp
        self.matches_ref = matches_ref
        self.chunks = chunks

    def __iadd__(self, other):
        for f in self.FIELDS:
            setattr(self, f, getattr(self, f) + getattr(other, f))
        return self

    def to_line(self):
        return " ".join(repr(getattr(self, f)) for f in self.FIELDS)

    @classmethod
    def from_line(cls, line):
        return cls(*(float(x) for x in line.split()))

    def score(self):
        """Meteor 1.5 formula on these (segment or summed) stats."""
        if not self.wlen_hyp or not self.wlen_ref:
            return 0.0
        p = self.wm_hyp / self.wlen_hyp
        r = self.wm_ref / self.wlen_ref
        if p <= 0.0 or r <= 0.0:
            return 0.0
        fmean = p * r / (ALPHA * p + (1.0 - ALPHA) * r)
        avg_matches = 0.5 * (self.matches_hyp + self.matches_ref)
        frag = self.chunks / avg_matches if avg_matches else 0.0
        return fmean * (1.0 - GAMMA * frag ** BETA)


def _content_weight(token):
    return (1.0 - DELTA) if token in FUNCTION_WORDS else DELTA


def segment_stats(hyp_tokens, ref_tokens, use_stem=False):
    """Stats of the best alignment of one hypothesis/reference pair."""
    pairs, chunks = align(hyp_tokens, ref_tokens, use_stem)
    s = SegmentStats(
        wlen_hyp=sum(_content_weight(t) for t in hyp_tokens),
        wlen_ref=sum(_content_weight(t) for t in ref_tokens),
        matches_hyp=float(len(pairs)), matches_ref=float(len(pairs)),
        chunks=float(chunks))
    for i, j, w in pairs:
        s.wm_hyp += w * _content_weight(hyp_tokens[i])
        s.wm_ref += w * _content_weight(ref_tokens[j])
    return s


def best_reference_stats(hyp_str, ref_strs, use_stem=False,
                         lowercase=True):
    """Stats vs the reference maximizing the segment score (the jar
    keeps the best-scoring reference's stats for aggregation)."""
    hyp = hyp_str.lower().split() if lowercase else hyp_str.split()
    best = None
    best_score = -1.0
    seen = set()
    for ref_str in ref_strs:
        # Identical reference strings yield identical stats, and the
        # strict '>' keeps the FIRST best, so skipping duplicates is
        # bit-identical. The reference eval protocol duplicates the
        # single ground-truth caption once per token position
        # (reference: models/baseline.py:345-350), so this turns ~11
        # alignments per sample into 1 at corpus scale.
        if ref_str in seen:
            continue
        seen.add(ref_str)
        ref = (ref_str.lower() if lowercase else ref_str).split()
        s = segment_stats(hyp, ref, use_stem)
        sc = s.score()
        if sc > best_score:
            best, best_score = s, sc
    return best if best is not None else SegmentStats()


class MeteorPy(object):
    """Drop-in for eval_func.Meteor backed by the pure-Python scorer.

    Same compute_score contract as the jar wrapper (icd_tpu/eval_func/
    meteor.py, reference: eval_func/meteor/meteor.py:33-58): gts/res
    are lists over samples of reference-string lists / 1-element
    hypothesis-string lists; returns (corpus_score, per_segment).
    """

    def __init__(self, use_stem=True):
        self.use_stem = use_stem

    def compute_score(self, gts, res):
        total = SegmentStats()
        scores = []
        for refs, hyp in zip(gts, res):
            assert len(hyp) == 1
            s = best_reference_stats(hyp[0], refs, self.use_stem)
            scores.append(s.score())
            total += s
        return total.score(), scores

    def method(self):
        return "METEOR"
