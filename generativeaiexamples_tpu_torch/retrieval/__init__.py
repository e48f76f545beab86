"""The port's retrieval layer: the vector-store interface, the card's
exact/IVF top-k search (``ann.py``) and the in-process store over it
(``torch_store.py``)."""
