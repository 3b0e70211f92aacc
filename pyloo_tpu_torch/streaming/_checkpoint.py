"""Checkpoint files of ``loo_streaming``: save, load, geometry check.

Counterpart of ``_save_checkpoint`` and ``_load_checkpoint`` in
``pyloo_tpu/streaming.py``, with the same ``.npz`` layout, version stamp and
messages, so a file written by either package resumes in the other when the
geometry matches.
"""

from __future__ import annotations

import os

import numpy as np
import torch

__all__ = ["CHECKPOINT_FORMAT_VERSION", "save_checkpoint", "load_checkpoint"]

# Checkpoint file format version.  Bump when the payload layout changes
# incompatibly; extend ``_COMPATIBLE_CHECKPOINT_VERSIONS`` (with a migration
# in ``load_checkpoint`` if needed) to keep older files resumable.
# Version history:
#   0 — pre-versioning files (no ``format_version`` entry); same layout as 1.
#   1 — explicit version stamp added.
CHECKPOINT_FORMAT_VERSION = 1
_COMPATIBLE_CHECKPOINT_VERSIONS = frozenset({0, 1})


def save_checkpoint(path, geometry, chunk, carry, buf_e, buf_d):
    """Atomically persist the streaming state.

    The carry is a handful of 0-d tensors; the optional pointwise buffers
    are ``(n_chunks * chunk_size,)``.  Copying them to the host waits for
    the queued chunks: that is the cost of a checkpoint.
    """
    payload = {f"carry_{k}": v.cpu().numpy() for k, v in carry.items()}
    payload["chunk"] = np.asarray(chunk)
    payload["format_version"] = np.asarray(CHECKPOINT_FORMAT_VERSION)
    for k, v in geometry.items():
        payload[f"geom_{k}"] = np.asarray(v)
    if buf_e is not None:
        payload["buf_e"] = buf_e.cpu().numpy()
        payload["buf_d"] = buf_d.cpu().numpy()
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        np.savez(fh, **payload)
    os.replace(tmp, path)


def load_checkpoint(path, geometry, device: torch.device):
    """Load a streaming checkpoint onto ``device``; None if absent.  Raises on
    a geometry mismatch (resuming a different problem silently would corrupt
    results) and on a format version it cannot read."""
    if not os.path.exists(path):
        return None
    with np.load(path, allow_pickle=False) as z:
        # files written before CHECKPOINT_FORMAT_VERSION existed carry no
        # stamp; their layout is identical to version 1, so they load as
        # version 0
        version = int(z["format_version"]) if "format_version" in z.files else 0
        if version not in _COMPATIBLE_CHECKPOINT_VERSIONS:
            if version > CHECKPOINT_FORMAT_VERSION:
                raise ValueError(
                    f"Checkpoint {path!r} has format version {version}, newer"
                    f" than this library's {CHECKPOINT_FORMAT_VERSION}."
                    " Upgrade pyloo_tpu, or delete the file to restart."
                )
            raise ValueError(
                f"Checkpoint {path!r} has unsupported format version"
                f" {version} and no migration is available. Delete the file"
                " to restart from chunk 0."
            )
        for k, v in geometry.items():
            # a missing key means the file was written by an older library
            # version (or a different entry point): same remedy as a value
            # mismatch, never a raw KeyError
            if f"geom_{k}" not in z.files:
                raise ValueError(
                    f"Checkpoint {path!r} has no recorded {k} (written by an"
                    f" older version?), but this run has {k}={v}. Delete the"
                    " file or fix the arguments."
                )
            got = z[f"geom_{k}"]
            if str(got) != str(np.asarray(v)):
                raise ValueError(
                    f"Checkpoint {path!r} was written for {k}={got}, but this"
                    f" run has {k}={v}. Delete the file or fix the arguments."
                )
        out = {
            "chunk": int(z["chunk"]),
            "carry": {
                k[len("carry_"):]: torch.from_numpy(z[k]).to(device)
                for k in z.files
                if k.startswith("carry_")
            },
        }
        if "buf_e" in z.files:
            out["buf_e"] = torch.from_numpy(z["buf_e"]).to(device)
            out["buf_d"] = torch.from_numpy(z["buf_d"]).to(device)
    return out
