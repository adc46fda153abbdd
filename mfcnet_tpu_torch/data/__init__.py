"""Host data layer: dataset file lists and ``.flo`` files (numpy only)."""
