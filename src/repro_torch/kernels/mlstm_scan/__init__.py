"""mLSTM (xLSTM matrix memory) scan: sm_90a CUDA intra-chunk kernel
(``kernel.py``), the chunked scan around it (``ops.py``) and the sequential
oracle (``ref.py``)."""
