"""The op-action vocabulary of the columnar formats, in the index order of
`automerge_tpu/storage.py` (the wire frames' `op_action` column holds these
indices). The rest of the columnar persistence is not ported yet."""

_ACTIONS = ("makeMap", "makeList", "makeText", "ins", "set", "del", "link",
            "move")
_ACTION_IDX = {a: i for i, a in enumerate(_ACTIONS)}
