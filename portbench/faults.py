"""Faults planted under the timed path, to show that the check catches
them: each takes the server or trainer of a run and breaks it in place.

- ``unchanged_state``: a step that leaves its state as it found it (a
  session's streams keep their tails and clocks; a trainer keeps its
  parameters and optimizer state);
- ``half_batch``: half of the batch left out (a session hands the first
  half's codes to the second half's streams; a trainer takes the mean loss
  over the first half of the rows);
- ``altered_token``: a code altered where it is produced (the first of
  every stream's codes in every call).

One chip runs every cell, so no exchange between chips can be left out.
"""

from __future__ import annotations


def _tails(sess) -> dict:
    return {sid: st.copy() for sid, st in sess._streams.items()}


def unchanged_state(obj) -> None:
    step = obj.step
    if hasattr(obj, "sess"):
        def broken():
            saved = _tails(obj.sess)
            out = step()
            obj.sess._streams.update(saved)
            return out
    else:
        def broken(tokens):
            saved = obj.state
            loss = step(tokens)
            obj.state = saved
            return loss
    obj.step = broken


def half_batch(obj) -> None:
    step = obj.step
    if hasattr(obj, "sess"):
        def broken():
            out = step()
            sids = list(out)
            half = len(sids) // 2
            for i, sid in enumerate(sids[half:]):
                out[sid] = out[sids[i]]
            return out
    else:
        def broken(tokens):
            return step(tokens[: tokens.shape[0] // 2])
    obj.step = broken


def altered_token(obj) -> None:
    step = obj.step

    def broken():
        out = step()
        for codes in out.values():
            codes[0] = (codes[0] + 1) % 256
        return out
    obj.step = broken


SERVING = {"unchanged_state": unchanged_state, "half_batch": half_batch,
           "altered_token": altered_token}
TRAINING = {"unchanged_state": unchanged_state, "half_batch": half_batch}
