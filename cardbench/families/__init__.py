"""One module per architecture family, found by a configuration's ``family``:
its weight groups and their layout, the closed forms of its work, and the
port's configuration that has to compute what the configuration states.
Each module gives ``group_names``, ``group_specs``, ``prefill_flops``,
``decode_flops``, ``k1_work`` and ``port_config``; a new family adds a
module here and its reference under ``reference/``, and edits nothing."""
