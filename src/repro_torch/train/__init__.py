"""The fault-tolerant step loop; port of `repro/train/`: atomic async
checkpoints (`checkpoint`), the loop with restart and straggler detection
(`runtime`), AdamW (`optim`) and int8 gradient compression with error
feedback (`compression`)."""
