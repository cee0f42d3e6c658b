"""Synthetic digit corpus, seeded lexicons, wav IO and the Aurora file
name conventions in numpy, for the port's CLI, smoke run and tests
(counterpart of ``speech_recognition_tpu/data`` and the scipy wav path
of ``speech_recognition_tpu/runtime``)."""
