"""Networks of the port: the StarMap keypoint network (``starmap.py``) and
the reader of its flax checkpoint (``flax_msgpack.py``)."""
