"""Host utilities: mid-run checkpoint/resume (``checkpoint``)."""
