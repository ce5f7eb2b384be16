"""Inference pipelines of the port: `svi_video.SVIVideoPipeline` (shot /
film), `svi_video_dance.SVIDanceVideoPipeline`,
`svi_video_talk.SVITalkVideoPipeline`, and `wan_video`'s
`WanVideoPipeline`, `WanUniAnimateVideoPipeline`,
`WanUniAnimateLongVideoPipeline` and `WanRepalceAnyoneVideoPipeline`."""
