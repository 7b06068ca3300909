from xotorch_tpu_torch.download.shard_download import LocalShardDownloader, NoopShardDownloader, ShardDownloader

__all__ = ["ShardDownloader", "NoopShardDownloader", "LocalShardDownloader"]
