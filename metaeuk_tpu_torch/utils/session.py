# Copy of metaeuk_tpu/utils/session.py; only the imports differ.
"""Process-level cache for target-side search artifacts.

The production deployment shape for this framework is a resident process
(see server.py): the target DB is long-lived while contig queries come
and go.  The reference gets the same effect from `createindex` — a
persisted prefilter index the next process run mmaps instead of
rebuilding (PrefilteringIndexReader.h:27, CreateIndex.cpp:14).  Here the
equivalents are in-process: the built k-mer index (target masking +
native index fill) and the SearchDriver's per-tier device staging of the
target set, both pure functions of (target DB content, parameters), are
kept across EasyPredict runs in the same process and keyed by a content
digest so any change to the targets or the parameters rebuilds.

Deliberately NOT cached: anything derived from the contigs/query side —
each request's queries are new work.
"""

import hashlib
from collections import OrderedDict

_CACHE = OrderedDict()
_MAX_ENTRIES = 3


def db_fingerprint(db):
    """Content digest of a SeqDB-like object (data + offsets); cached on
    the object so repeated runs hash once."""
    fp = getattr(db, "_content_fp", None)
    if fp is None:
        h = hashlib.blake2b(digest_size=16)
        h.update(db.data.tobytes())
        h.update(db.offsets.tobytes())
        fp = (len(db), int(db.offsets[-1]), h.hexdigest())
        try:
            db._content_fp = fp
        except AttributeError:
            pass
    return fp


def cached(kind, key, builder):
    """Return the cached artifact for (kind, key), building on miss.
    LRU-bounded to a few entries (a target index + driver staging pair
    is hundreds of MB at scale)."""
    k = (kind, key)
    v = _CACHE.get(k)
    if v is None:
        v = builder()
        while len(_CACHE) >= _MAX_ENTRIES:
            _CACHE.popitem(last=False)
        _CACHE[k] = v
    else:
        _CACHE.move_to_end(k)
    return v


def clear():
    _CACHE.clear()
