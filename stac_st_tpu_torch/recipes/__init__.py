"""The recipes over the port, each runnable with ``python -m``:
``train_multitask`` (train, validate, checkpoint, average, evaluate),
``inference`` (ASR + ST and the CTC head's RTTM for each split of a
trained experiment) and ``train_tokenizer``."""
