from .npz import check_schedule_meta, load_checkpoint, save_checkpoint
