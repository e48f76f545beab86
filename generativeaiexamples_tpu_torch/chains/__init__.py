"""The port's example chains (``developer_rag``, ``echo``), their registry
and the runtime they share (``runtime.py``)."""
