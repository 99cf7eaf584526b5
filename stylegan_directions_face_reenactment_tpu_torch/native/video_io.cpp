// video_io: video decode and encode on libav for the PyTorch port's CLI.
//
// The reference reads and writes videos with OpenCV
// (`libs/utilities/utils_inference.py:11-58`, extract_frames /
// generate_video); this library does the same on
// libavformat/libavcodec/libswscale:
//
//   * rio_video_open / rio_video_read / rio_video_close: demux and decode an
//     mp4/avi into RGB24 frames, taking every stride-th frame (the
//     reference's `fps` parameter is a stride);
//   * rio_writer_open / rio_writer_write / rio_writer_close: encode RGB24
//     frames into an mp4 (libx264 where the libav build has it, else mpeg4,
//     the reference's `mp4v`).
//
// A plain C interface for ctypes (`native/imgproc.py`), built with g++ at
// first use. It is a copy of the video half of the JAX package's
// `native/reenact_io.cpp`; the image operations are PyTorch in the port.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/imgutils.h>
#include <libavutil/opt.h>
#include <libswscale/swscale.h>
}

extern "C" {

// ---------------------------------------------------------------------------
// Decoder
// ---------------------------------------------------------------------------

struct RioVideo {
    AVFormatContext* fmt = nullptr;
    AVCodecContext* dec = nullptr;
    SwsContext* sws = nullptr;
    int stream_index = -1;
    int width = 0;
    int height = 0;
    double fps = 0.0;
    long decoded = 0;  // persists across rio_video_read calls (stride state)
    AVPacket* pending = nullptr;  // packet the decoder refused (EAGAIN)
};

void* rio_video_open(const char* path) {
    auto* v = new RioVideo();
    if (avformat_open_input(&v->fmt, path, nullptr, nullptr) < 0) {
        delete v;
        return nullptr;
    }
    if (avformat_find_stream_info(v->fmt, nullptr) < 0) {
        avformat_close_input(&v->fmt);
        delete v;
        return nullptr;
    }
    const AVCodec* codec = nullptr;
    v->stream_index = av_find_best_stream(v->fmt, AVMEDIA_TYPE_VIDEO, -1, -1,
                                          &codec, 0);
    if (v->stream_index < 0 || !codec) {
        avformat_close_input(&v->fmt);
        delete v;
        return nullptr;
    }
    AVStream* st = v->fmt->streams[v->stream_index];
    v->dec = avcodec_alloc_context3(codec);
    avcodec_parameters_to_context(v->dec, st->codecpar);
    // frame-threaded decode; hardware_concurrency reports 1 in some
    // containers, so keep a floor — idle threads cost ~nothing, missing
    // ones serialize the codec
    {
        unsigned hc = std::thread::hardware_concurrency();
        v->dec->thread_count = hc > 8 ? (int)hc : 8;
    }
    v->dec->thread_type = FF_THREAD_FRAME | FF_THREAD_SLICE;
    if (avcodec_open2(v->dec, codec, nullptr) < 0) {
        avcodec_free_context(&v->dec);
        avformat_close_input(&v->fmt);
        delete v;
        return nullptr;
    }
    v->width = v->dec->width;
    v->height = v->dec->height;
    AVRational r = st->avg_frame_rate;
    v->fps = r.den ? (double)r.num / r.den : 0.0;
    return v;
}

int rio_video_width(void* h) { return ((RioVideo*)h)->width; }
int rio_video_height(void* h) { return ((RioVideo*)h)->height; }
double rio_video_fps(void* h) { return ((RioVideo*)h)->fps; }

// Read up to max_frames frames (taking every `stride`-th decoded frame)
// into out (max_frames * height * width * 3, RGB24). Returns frames read.
int rio_video_read(void* h, uint8_t* out, int max_frames, int stride) {
    auto* v = (RioVideo*)h;
    if (stride < 1) stride = 1;
    AVPacket* pkt = av_packet_alloc();
    AVFrame* frame = av_frame_alloc();
    AVFrame* rgb = av_frame_alloc();

    const size_t frame_bytes = (size_t)v->width * v->height * 3;
    int written = 0;

    if (!v->sws) {
        v->sws = sws_getContext(v->width, v->height, v->dec->pix_fmt,
                                v->width, v->height, AV_PIX_FMT_RGB24,
                                SWS_BILINEAR, nullptr, nullptr, nullptr);
    }

    auto emit = [&](AVFrame* f) {
        if (written >= max_frames) return;
        if (v->decoded % stride == 0) {
            uint8_t* dst_data[1] = {out + (size_t)written * frame_bytes};
            int dst_linesize[1] = {3 * v->width};
            sws_scale(v->sws, f->data, f->linesize, 0, v->height, dst_data,
                      dst_linesize);
            written++;
        }
        v->decoded++;
    };

    // A packet must never be read from the demuxer and then dropped:
    // B-frame decoders return EAGAIN from send while frames are pending,
    // and a full output buffer can force an early return — the refused
    // packet is stashed in v->pending and re-sent on the next call.
    bool eof = false;
    while (written < max_frames) {
        const bool from_pending = v->pending != nullptr;
        AVPacket* cur;
        if (from_pending) {
            cur = v->pending;
        } else {
            if (av_read_frame(v->fmt, pkt) < 0) { eof = true; break; }
            if (pkt->stream_index != v->stream_index) {
                av_packet_unref(pkt);
                continue;
            }
            cur = pkt;
        }
        const int s = avcodec_send_packet(v->dec, cur);
        if (s == AVERROR(EAGAIN)) {
            if (!from_pending) {
                v->pending = av_packet_alloc();
                av_packet_move_ref(v->pending, pkt);
            }
        } else {  // consumed (0) or hard error: release the packet
            if (from_pending) av_packet_free(&v->pending);
            else av_packet_unref(pkt);
        }
        while (avcodec_receive_frame(v->dec, frame) == 0) {
            emit(frame);
            if (written >= max_frames) break;
        }
    }
    // flush only at true end-of-stream (a full output buffer is not EOF)
    if (eof && !v->pending) {
        avcodec_send_packet(v->dec, nullptr);
        while (avcodec_receive_frame(v->dec, frame) == 0 &&
               written < max_frames) {
            emit(frame);
        }
    }
    av_frame_free(&rgb);
    av_frame_free(&frame);
    av_packet_free(&pkt);
    return written;
}

void rio_video_close(void* h) {
    auto* v = (RioVideo*)h;
    if (v->pending) av_packet_free(&v->pending);
    if (v->sws) sws_freeContext(v->sws);
    if (v->dec) avcodec_free_context(&v->dec);
    if (v->fmt) avformat_close_input(&v->fmt);
    delete v;
}

// ---------------------------------------------------------------------------
// Encoder: h264-in-mp4 via libx264 when available (universally decodable,
// none of mpeg4's last-frame flush quirks), mpeg4 fallback (the
// reference's cv2 `mp4v` writer equivalent).
// ---------------------------------------------------------------------------

struct RioWriter {
    AVFormatContext* fmt = nullptr;
    AVCodecContext* enc = nullptr;
    AVStream* stream = nullptr;
    SwsContext* sws = nullptr;
    AVFrame* yuv = nullptr;
    int width = 0, height = 0;
    int64_t pts = 0;
};

void* rio_writer_open(const char* path, int width, int height, int fps) {
    auto* w = new RioWriter();
    w->width = width;
    w->height = height;
    avformat_alloc_output_context2(&w->fmt, nullptr, "mp4", path);
    if (!w->fmt) { delete w; return nullptr; }
    const AVCodec* codec = avcodec_find_encoder_by_name("libx264");
    if (!codec) codec = avcodec_find_encoder(AV_CODEC_ID_MPEG4);
    if (!codec) { avformat_free_context(w->fmt); delete w; return nullptr; }
    w->stream = avformat_new_stream(w->fmt, codec);
    w->enc = avcodec_alloc_context3(codec);
    w->enc->width = width;
    w->enc->height = height;
    w->enc->pix_fmt = AV_PIX_FMT_YUV420P;
    w->enc->time_base = AVRational{1, fps};
    // frame-threaded encode: x264 gets threads=1 through libav unless the
    // context asks (thread_count=0 "auto" also resolves to 1 in
    // containers whose hardware_concurrency reports 1), so ask for threads
    {
        unsigned hc = std::thread::hardware_concurrency();
        w->enc->thread_count = hc > 8 ? (int)hc : 8;
    }
    w->enc->thread_type = FF_THREAD_FRAME | FF_THREAD_SLICE;
    if (codec->id == AV_CODEC_ID_H264) {
        av_opt_set(w->enc->priv_data, "preset", "veryfast", 0);
        av_opt_set(w->enc->priv_data, "crf", "18", 0);
        // no B-frames: this libav build's h264 decoder drops the final
        // reordered frame of a B-frame stream at EOF
        w->enc->max_b_frames = 0;
    } else {
        w->enc->bit_rate = 4'000'000;
    }
    if (w->fmt->oformat->flags & AVFMT_GLOBALHEADER)
        w->enc->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
    if (avcodec_open2(w->enc, codec, nullptr) < 0) {
        avcodec_free_context(&w->enc);
        avformat_free_context(w->fmt);
        delete w;
        return nullptr;
    }
    avcodec_parameters_from_context(w->stream->codecpar, w->enc);
    w->stream->time_base = w->enc->time_base;
    if (!(w->fmt->oformat->flags & AVFMT_NOFILE)) {
        if (avio_open(&w->fmt->pb, path, AVIO_FLAG_WRITE) < 0) {
            avcodec_free_context(&w->enc);
            avformat_free_context(w->fmt);
            delete w;
            return nullptr;
        }
    }
    if (avformat_write_header(w->fmt, nullptr) < 0) {
        avcodec_free_context(&w->enc);
        avformat_free_context(w->fmt);
        delete w;
        return nullptr;
    }
    w->sws = sws_getContext(width, height, AV_PIX_FMT_RGB24, width, height,
                            AV_PIX_FMT_YUV420P, SWS_BILINEAR, nullptr,
                            nullptr, nullptr);
    w->yuv = av_frame_alloc();
    w->yuv->format = AV_PIX_FMT_YUV420P;
    w->yuv->width = width;
    w->yuv->height = height;
    av_frame_get_buffer(w->yuv, 0);
    return w;
}

static int rio_writer_flush_packets(RioWriter* w) {
    AVPacket* pkt = av_packet_alloc();
    int ret;
    while ((ret = avcodec_receive_packet(w->enc, pkt)) == 0) {
        av_packet_rescale_ts(pkt, w->enc->time_base, w->stream->time_base);
        pkt->stream_index = w->stream->index;
        av_interleaved_write_frame(w->fmt, pkt);
        av_packet_unref(pkt);
    }
    av_packet_free(&pkt);
    return ret == AVERROR(EAGAIN) || ret == AVERROR_EOF ? 0 : ret;
}

int rio_writer_write(void* h, const uint8_t* rgb) {
    auto* w = (RioWriter*)h;
    const uint8_t* src_data[1] = {rgb};
    int src_linesize[1] = {3 * w->width};
    av_frame_make_writable(w->yuv);
    sws_scale(w->sws, src_data, src_linesize, 0, w->height, w->yuv->data,
              w->yuv->linesize);
    w->yuv->pts = w->pts++;
    if (avcodec_send_frame(w->enc, w->yuv) < 0) return -1;
    return rio_writer_flush_packets(w);
}

int rio_writer_close(void* h) {
    auto* w = (RioWriter*)h;
    avcodec_send_frame(w->enc, nullptr);
    rio_writer_flush_packets(w);
    av_write_trailer(w->fmt);
    if (!(w->fmt->oformat->flags & AVFMT_NOFILE)) avio_closep(&w->fmt->pb);
    sws_freeContext(w->sws);
    av_frame_free(&w->yuv);
    avcodec_free_context(&w->enc);
    avformat_free_context(w->fmt);
    delete w;
    return 0;
}

}  // extern "C"
