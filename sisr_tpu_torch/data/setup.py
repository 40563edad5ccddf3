"""sisr_data_setup: train and eval loaders from the TOML data tables (PyTorch port of
sisr_tpu's ``data/setup.py``, ref: Code/SISR/training/data_setup.py:9-125).  Under a
process group of more than one rank each rank loads only its slice of every training
batch (``DataLoader(process_shard=...)``); validation stays replicated, as in
sisr_tpu (eval batches default to one image, and rank 0 alone writes)."""
import os

from ..parallel import distributed
from .datasets import SuperResImages
from .loader import CelebaSplitSampler, ConcatDataset, DataLoader


def sisr_data_setup(training_sets, eval_sets, batch_size=16, eval_batch_size=1,
                    dataloader_threads=8, drop_last_training_batch=False,
                    extract_masks=False, rep_partition=None, attributes=None,
                    blacklists=None, sampler_attributes=None, **kwargs):
    """(train loader, eval loader).  Each entry of ``training_sets`` / ``eval_sets`` is
    a data table (name, lr, hr, cutoff, degradation_metadata, metadata, crop,
    random_augment, request_crops, ...); a missing key reads as None.  ``kwargs``
    (the model's input and colorspace) go to every dataset."""

    def setup_data(data_set, split):
        get = data_set.get
        usage = split  # 'train' or 'eval', before the split is rewritten
        custom_range = None
        if get('cutoff') is not None:
            custom_range = get('cutoff') if type(get('cutoff')) == list \
                else (0, get('cutoff'))
        elif get('name') is None:
            split = 'all'

        metadata_file = get('degradation_metadata')
        if get('qpi_values') is not None:  # legacy alias
            metadata_file = get('qpi_values')
        if metadata_file == 'on_site':
            metadata_file = os.path.join(get('lr'), 'degradation_metadata.csv')
            if not os.path.isfile(metadata_file):
                metadata_file = os.path.join(get('lr'), 'qpi_slices.csv')

        blacklist = blacklists[get('name')] \
            if blacklists is not None and get('name') in blacklists else None
        data_attributes = attributes[get('name')] \
            if attributes is not None and get('name') is not None else None

        return SuperResImages(
            lr_dir=get('lr'), hr_dir=get('hr'), blacklist=blacklist,
            data_attributes=data_attributes, image_shortlist=get('image_shortlist'),
            metadata=get('metadata'), dataset=get('name'), split=split,
            y_only=split != 'eval', custom_split=custom_range,
            degradation_metadata_file=metadata_file,
            legacy_blur_kernels=get('legacy_blur_kernels'), random_crop=get('crop'),
            random_augments=get('random_augment'),
            recursive_search=get('recursive_search') or False,
            mask_data=os.path.join(get('hr'), 'segmentation_patterns')
            if extract_masks else None,
            online_degradations=get('online_degradations'),
            online_degradation_params=get('online_degradation_params'),
            attribute_amplification=get('attribute_amplification'),
            request_crops=get('request_crops'), cache_decoded=get('cache_decoded'),
            usage=usage, **kwargs)

    print('---------------')
    print('preparing training data:')
    all_train_data = [setup_data(train_set, 'train') for train_set in training_sets.values()]
    print('---------------')
    print('preparing validation data:')
    all_val_data = [setup_data(eval_set, 'eval') for eval_set in eval_sets.values()]
    print('---------------')

    all_train_data = all_train_data[0] if len(all_train_data) == 1 \
        else ConcatDataset(all_train_data)
    all_val_data = all_val_data[0] if len(all_val_data) == 1 else ConcatDataset(all_val_data)

    sampler = None
    if sampler_attributes is not None:
        if sampler_attributes['name'].lower() != 'celebasplitsampler':
            raise RuntimeError('Selected data sampler not recognized.')
        sampler = CelebaSplitSampler(all_train_data, **sampler_attributes)

    train_dataloader = DataLoader(dataset=all_train_data, batch_size=batch_size,
                                  shuffle=sampler is None,
                                  num_workers=8 if dataloader_threads is None
                                  else dataloader_threads,
                                  drop_last=bool(drop_last_training_batch), sampler=sampler,
                                  process_shard=(distributed.rank(), distributed.world_size())
                                  if distributed.world_size() > 1 else None)
    val_dataloader = DataLoader(dataset=all_val_data, batch_size=eval_batch_size)
    return train_dataloader, val_dataloader
