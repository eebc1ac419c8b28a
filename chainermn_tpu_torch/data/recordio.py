"""Record-shard file format: the on-disk half of the streaming input
pipeline.

Counterpart of ``chainermn_tpu/data/recordio.py``, byte for byte the same
format, so each package reads the other's shards.  A shard is an
append-only file of length+crc32-framed payload records with a JSON
**index sidecar** written only after the shard itself has been atomically
committed (tmp + fsync + rename, sidecar after the commit, so a crash
mid-write never leaves a shard that looks complete).

Layout of ``<name>.rec``::

    8 bytes   magic  b'CMNSHRD1'
    repeated  [u32 payload length][u32 crc32(payload)][payload bytes]

and ``<name>.rec.idx`` (the sidecar)::

    {"magic": "CMNSHRD1", "n_records": N, "offsets": [...],
     "lengths": [...], "complete": true}

Integrity is typed: every defect a reader can hit (a missing or torn
sidecar, record bytes past the end of the file, a crc mismatch) raises
:class:`~chainermn_tpu_torch.utils.failure.DataCorruptError` naming the
shard, record and byte offset, so the loader above can skip and count
instead of training on corrupt samples.  A payload is ``np.savez`` of the
example's arrays; ``np.savez`` stamps each zip member with the wall time,
so two writes of one example are equal once decoded, not byte for byte.
:meth:`ShardReader.read` carries the JAX reader's fault-injection sites
(:mod:`~chainermn_tpu_torch.utils.chaos`): ``data_stall`` before the read,
``data_corrupt`` on the payload before its crc check.
"""

import glob as _glob
import io
import json
import os
import struct
import zlib

import numpy as np

from chainermn_tpu_torch.utils import chaos as _chaos
from chainermn_tpu_torch.utils import failure

MAGIC = b'CMNSHRD1'
_REC_HDR = struct.Struct('<II')  # payload length, crc32(payload)

INDEX_SUFFIX = '.idx'


def index_path(path):
    """The sidecar path of shard ``path``."""
    return path + INDEX_SUFFIX


# ----------------------------------------------------------------------
# example codec (numpy tuples <-> bytes)
# ----------------------------------------------------------------------

def encode_example(example):
    """Serialize an example -- a numpy array or a tuple/list of them
    (e.g. ``(image, label)``) -- into one record payload.  The codec
    is plain ``np.savez`` over a BytesIO (no pickle: payloads stay
    loadable across Python versions and are safe to read from
    untrusted shards)."""
    arrays = (example if isinstance(example, (tuple, list))
              else (example,))
    bio = io.BytesIO()
    np.savez(bio, *[np.asarray(a) for a in arrays])
    return bio.getvalue()


def decode_example(payload):
    """Inverse of :func:`encode_example`: payload bytes -> tuple of
    numpy arrays (single-array examples come back as a 1-tuple).
    Raises ``ValueError``/``zipfile.BadZipFile`` subclasses on
    garbage -- callers go through :meth:`ShardReader.read`, whose crc
    check already typed-rejects corrupt payloads before decode."""
    with np.load(io.BytesIO(payload)) as z:
        return tuple(z['arr_%d' % i] for i in range(len(z.files)))


# ----------------------------------------------------------------------
# writer
# ----------------------------------------------------------------------

class ShardWriter:
    """Append records to ``<path>.tmp``; ``close()`` fsyncs, atomically
    renames to ``path`` and THEN writes the index sidecar -- the
    write-complete sentinel.  A reader that finds a shard without its
    sidecar treats it as torn (crash mid-write), never as data.

    Usable as a context manager::

        with ShardWriter('train-00000.rec') as w:
            for ex in examples:
                w.append(encode_example(ex))
    """

    def __init__(self, path):
        self.path = path
        self._tmp = path + '.tmp'
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        self._f = open(self._tmp, 'wb')
        self._f.write(MAGIC)
        self.offsets = []
        self.lengths = []
        self.closed = False

    def append(self, payload):
        """Write one record; returns its index within the shard."""
        if self.closed:
            raise ValueError('ShardWriter %s is closed' % self.path)
        payload = bytes(payload)
        self.offsets.append(self._f.tell())
        self.lengths.append(len(payload))
        self._f.write(_REC_HDR.pack(len(payload),
                                    zlib.crc32(payload) & 0xffffffff))
        self._f.write(payload)
        return len(self.offsets) - 1

    def close(self):
        """Commit: fsync + rename the shard, then write the sidecar
        (itself tmp+renamed).  Returns the shard path."""
        if self.closed:
            return self.path
        self._f.flush()
        os.fsync(self._f.fileno())
        self._f.close()
        os.replace(self._tmp, self.path)
        idx = {'magic': MAGIC.decode('ascii'),
               'n_records': len(self.offsets),
               'offsets': self.offsets,
               'lengths': self.lengths,
               'complete': True}
        ipath = index_path(self.path)
        tmp = ipath + '.tmp'
        with open(tmp, 'w') as f:
            json.dump(idx, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, ipath)
        self.closed = True
        return self.path

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.close()
        else:  # abandoned write: leave no committed shard behind
            self._f.close()
            self.closed = True
            for p in (self._tmp,):
                try:
                    os.remove(p)
                except OSError:
                    pass
        return False


# ----------------------------------------------------------------------
# reader
# ----------------------------------------------------------------------

def read_index(path):
    """Load + validate the sidecar of shard ``path``; typed
    :class:`~chainermn_tpu_torch.utils.failure.DataCorruptError` on a
    missing, unparseable or sentinel-less sidecar."""
    ipath = index_path(path)
    try:
        with open(ipath) as f:
            idx = json.load(f)
    except OSError as e:
        raise failure.DataCorruptError(
            'shard %s has no readable index sidecar (%s) -- torn or '
            'never committed' % (path, e), shard=path,
            kind='unreadable')
    except ValueError as e:
        raise failure.DataCorruptError(
            'shard %s index sidecar is unparseable (%s)' % (path, e),
            shard=path, kind='unreadable')
    if not idx.get('complete'):
        raise failure.DataCorruptError(
            'shard %s index sidecar lacks the write-complete '
            'sentinel' % path, shard=path, kind='truncated')
    if len(idx.get('offsets', ())) != idx.get('n_records') or \
            len(idx.get('lengths', ())) != idx.get('n_records'):
        raise failure.DataCorruptError(
            'shard %s index sidecar is inconsistent '
            '(n_records=%r, %d offsets, %d lengths)'
            % (path, idx.get('n_records'),
               len(idx.get('offsets', ())),
               len(idx.get('lengths', ()))),
            shard=path, kind='truncated')
    return idx


class ShardReader:
    """Random-access reads over one committed shard.

    Reads go through ``os.pread`` on a shared fd (positional, so the
    decode worker THREADS of a loader share one reader without seek
    races).  Every read verifies the record crc32 -- a flipped byte
    surfaces as a typed ``DataCorruptError(kind='crc')`` naming the
    shard, record and byte offset; a record extending past EOF (torn
    file) as ``kind='truncated'``."""

    def __init__(self, path, verify=True):
        self.path = path
        self.verify = verify
        self.index = read_index(path)
        self._fd = os.open(path, os.O_RDONLY)
        try:
            head = os.pread(self._fd, len(MAGIC), 0)
        except OSError as e:
            raise failure.DataCorruptError(
                'shard %s is unreadable (%s)' % (path, e),
                shard=path, kind='unreadable')
        if head != MAGIC:
            raise failure.DataCorruptError(
                'shard %s has a bad magic header %r' % (path, head),
                shard=path, offset=0, kind='truncated')

    def __len__(self):
        return self.index['n_records']

    def read(self, i):
        """Record ``i``'s payload bytes (crc-verified)."""
        n = len(self)
        if not 0 <= i < n:
            raise IndexError('record %d out of range for shard %s '
                             '(%d records)' % (i, self.path, n))
        if _chaos._active is not None:
            _chaos.on_data_read()  # data_stall: delayed shard read
        off = self.index['offsets'][i]
        head = os.pread(self._fd, _REC_HDR.size, off)
        if len(head) != _REC_HDR.size:
            raise failure.DataCorruptError(
                'shard %s record %d header truncated at offset %d'
                % (self.path, i, off), shard=self.path, offset=off,
                record=i, kind='truncated')
        length, crc = _REC_HDR.unpack(head)
        payload = os.pread(self._fd, length, off + _REC_HDR.size)
        if len(payload) != length:
            raise failure.DataCorruptError(
                'shard %s record %d truncated: wanted %d payload '
                'bytes at offset %d, file holds %d'
                % (self.path, i, length, off, len(payload)),
                shard=self.path, offset=off, record=i,
                kind='truncated')
        if _chaos._active is not None:
            payload = _chaos.corrupt_record(payload)  # data_corrupt
        if self.verify and (zlib.crc32(payload) & 0xffffffff) != crc:
            raise failure.DataCorruptError(
                'shard %s record %d failed crc32 verification at '
                'offset %d' % (self.path, i, off), shard=self.path,
                offset=off, record=i, kind='crc')
        return payload

    def close(self):
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None

    def __del__(self):  # best-effort fd hygiene
        try:
            self.close()
        except Exception:
            pass


class ShardSet:
    """A globally-indexed view over an ordered list of shards: sample
    id ``g`` lives at ``(shard, local)`` by cumulative shard lengths.
    Zero-length shards are legal (an empty shard contributes no ids
    and shifts nothing)."""

    def __init__(self, paths, verify=True):
        self.paths = list(paths)
        self.readers = [ShardReader(p, verify=verify)
                        for p in self.paths]
        self.lengths = [len(r) for r in self.readers]
        self._cum = np.cumsum([0] + self.lengths)

    @classmethod
    def from_dir(cls, dirpath, pattern='*.rec', verify=True):
        paths = sorted(_glob.glob(os.path.join(dirpath, pattern)))
        if not paths:
            raise failure.DataCorruptError(
                'no %r shards under %s' % (pattern, dirpath),
                shard=dirpath, kind='unreadable')
        return cls(paths, verify=verify)

    def __len__(self):
        return int(self._cum[-1])

    def locate(self, gid):
        """``(shard index, local record index)`` of global id
        ``gid``."""
        n = len(self)
        if not 0 <= gid < n:
            raise IndexError('sample id %d out of range (%d total)'
                             % (gid, n))
        s = int(np.searchsorted(self._cum, gid, side='right')) - 1
        return s, int(gid - self._cum[s])

    def read(self, gid):
        """Global sample ``gid``'s payload bytes."""
        s, i = self.locate(gid)
        return self.readers[s].read(i)

    def close(self):
        for r in self.readers:
            r.close()


def write_examples(examples, out_dir, n_shards=1, prefix='train',
                   encode=encode_example):
    """Shard ``examples`` (a sequence or anything with ``__len__`` /
    ``__getitem__``) into ``n_shards`` contiguous record shards under
    ``out_dir`` -- the balanced quotient split of
    ``dataset.scatter_index``, so shard lengths differ by at most
    one.  Returns the committed shard paths."""
    from chainermn_tpu_torch.dataset import scatter_index
    if n_shards < 1:
        raise ValueError('n_shards must be >= 1')
    os.makedirs(out_dir, exist_ok=True)
    n = len(examples)
    paths = []
    for s in range(n_shards):
        lo, hi = scatter_index(n, n_shards, s)
        path = os.path.join(
            out_dir, '%s-%05d-of-%05d.rec' % (prefix, s, n_shards))
        with ShardWriter(path) as w:
            for i in range(lo, hi):
                w.append(encode(examples[i]))
        paths.append(path)
    return paths
